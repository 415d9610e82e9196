"""Training over the reference's ``(data, model)`` mesh:
``Trainer(model, tcfg, device, group=g, mesh=MeshShape(data=d, model=m))``
over ``torch.distributed`` ranks, against one process and the reference.

On the CPU over gloo: four processes (``torch.multiprocessing``, a
``FileStore``, one torch thread each) train the reduced transformer
families (f32) with 4 workers on the meshes ``(2, 2)``, ``(1, 4)`` and
``(4, 1)`` (granite, qwen2.5 and starcoder2 on the first and the last,
beside nanogpt at all three): nanogpt-124m (learned positions, the tied unembedding) and
granite-3-2b (the reference's SPMD arm) with packed ``top10+natural`` /
``--s2w natural``; qwen2.5-3b (QKV bias, tied), starcoder2-15b at
window 6 (the windowed ring), mixtral-8x7b (the experts cut on E),
deepseek-v3-671b (MLA, the shared expert, MTP) and qwen2-vl-7b (M-RoPE
over an ``embeds`` batch) with lossless worker messages and ``--s2w
natural``; and nanogpt with the identity compressors both ways. Params
are the reference's
``model.init`` carried by ``params_from_jax``, batches numpy draws from
a seed. For every case and rank:

  * ``(4, 1)`` is the 4-rank group path without a mesh, bit for bit
    (run beside it for nanogpt's two arms and granite);
  * step 0's loss is within ``1e-6 (1 + |l|)`` of one process's, and
    each leaf's step-0 gradient, gathered whole, within ``1e-5 (1 +
    max|g|)``;
  * one step from one process's state after step 1, fed the gradients
    that process used, gives x, W and g_server within ``1e-5 (1 + |v|)``
    of its state after step 2 (the compressors see bit-equal inputs;
    the NS gram partials are summed in another order);
  * the 3-step losses are within ``tests/test_torch_ranks.py``'s bounds
    of the reference's from the same state and batches;
  * the bytes at rest of x, w, g_server, g_w and m_w are the specs'
    (``Trainer.state_specs()``, ``spec_bytes``), and ``Trainer.init``
    (each rank drawing its chunks) is the cut of one process's, bit for
    bit;
  * every collective of the mesh carries a ``TRAIN_TAGS`` tag (no
    parameter crosses), the compressors' inputs move each rank's chunks
    of the cut leaves, and the wire moves the budget's bytes.

Beside them: the reference's own ``Trainer`` over its ``(2, 2)`` mesh
(a subprocess with 4 host devices, ``use_pallas=False``) gives the
port's step-0 loss on reduced granite, and from one process's state
after step 0 (a nonzero radius) the ranks' own step-1 loss and x with
lossless workers; the column-cut
NS chain (``kernels.ops.newton_schulz_cols``) against the whole chain;
checkpoints between ``(2, 2)`` and one process both ways, bit-equal;
the refusals.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.core.schedule import warmup_linear_decay
from repro_torch.dist.sharding import TRAIN_TAGS, MeshShape
from repro_torch.models.api import build_model, params_from_jax
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_threads import one_torch_thread  # noqa: F401

WORLD, N_WORKERS, ROWS, SEQ, STEPS = 4, 4, 1, 8, 3
TWO_WAY = dict(n_workers=N_WORKERS, beta=0.5, w2s="top10+natural",
               s2w="natural")
IDENTITY = dict(n_workers=N_WORKERS, beta=0.5, w2s="identity",
                s2w="identity")
# the other archs' arm: the workers' messages lossless, the server's
# Natural (TopK's stable sort of every slice on every rank of a data row
# is most of a rank's time on the CPU; granite and nanogpt run it)
NATURAL = dict(n_workers=N_WORKERS, beta=0.5, w2s="identity", s2w="natural")
MESHES = ((2, 2), (1, 4), (4, 1))
ARCHS = ("nanogpt-124m", "granite-3-2b", "qwen2.5-3b", "starcoder2-15b",
         "mixtral-8x7b", "deepseek-v3-671b", "qwen2-vl-7b")
# the server's state also cut over ``data`` by the zero-1 and FSDP rules
PLACEMENTS = {"zero1": {"zero1_lmo": True}, "fsdp": {"fsdp": True}}
# the (4, 1) cases also run as the 4-rank group without a mesh (a model
# axis of one takes that path: the TopK archs and the identity arm show it)
GROUP_PATH = {("nanogpt-124m", 1, "two_way"), ("nanogpt-124m", 1, "identity"),
              ("granite-3-2b", 1, "two_way")}
ARM = {a: "two_way" if a in ("nanogpt-124m", "granite-3-2b") else "natural"
       for a in ARCHS}
# every family at every mesh; the dense archs beside nanogpt skip (1, 4),
# where each rank runs all 4 workers
CASES = ([(a, m, ARM[a]) for a in ARCHS for m in MESHES
          if m != (1, 4) or a not in ("granite-3-2b", "qwen2.5-3b",
                                      "starcoder2-15b")]
         + [("nanogpt-124m", m, "identity") for m in MESHES]
         + [("nanogpt-124m", (2, 2), f"two_way+{p}") for p in PLACEMENTS]
         # (reduced mixtral's one-layer stacks give zero-1 nothing to cut)
         + [("mixtral-8x7b", (2, 2), "natural+fsdp")])
LOSS_TOL, GRAD_TOL, STEP_TOL, CHAIN_TOL = 1e-6, 1e-5, 1e-5, 1e-6
# the reference's (2, 2) mesh: its step 0 beside the ranks' (the radius is
# 0 there, so x does not move), and step 1 of REF_STEP_ARM (lossless
# workers: with TopK, gradients within 1e-7 of the reference's may pick
# other entries) from one process's state after step 0
REF_CASE = ("granite-3-2b", (2, 2), "two_way")
REF_STEP_ARM = "natural"
JOIN_S = 420

JAX_MESH_SCRIPT = """
import pickle, sys
import jax, jax.numpy as jnp, ml_dtypes, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models.api import build_model
from repro.train.trainer import Trainer, TrainerConfig

def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if tree is None:
        return None
    a = np.asarray(tree)
    if a.dtype == np.dtype("V2"):
        a = a.view(ml_dtypes.bfloat16)
    return jnp.asarray(a)

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = []
for run in inp["runs"]:
    tr = Trainer(build_model(get_config("granite-3-2b").reduced()),
                 TrainerConfig(use_pallas=False, remat=False, **run["kw"]),
                 mesh=mesh)
    batch = {k: jnp.asarray(v) for k, v in run["batch"].items()}
    sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                       batch)
    step = tr.jit_step(sds)
    state = jax.device_put(to_jax(run["state"]), tr.shardings(sds)[0])
    state, aux = step(state, batch, jnp.asarray(run["t"], jnp.float32))
    out.append({"loss": float(aux["loss"]),
                "x": jax.tree.map(np.asarray, state["x"])})
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _cfgs(name: str):
    from repro.configs import get_config as jget_config
    cfg, jcfg = get_config(name).reduced(), jget_config(name).reduced()
    if name == "starcoder2-15b":
        cfg = dataclasses.replace(cfg, window=6)
        jcfg = dataclasses.replace(jcfg, window=6)
    return cfg, jcfg


def _batches(cfg) -> list[dict]:
    """STEPS batches ``[N_WORKERS, ROWS, ...]`` as numpy arrays."""
    rng = np.random.default_rng(5)
    lead = (N_WORKERS, ROWS)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab, lead + (SEQ + 1,)).astype(np.int32)
        b = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        if cfg.family == "vlm":
            b = {"embeds": (rng.standard_normal(lead + (SEQ, cfg.d_model))
                            * 0.02).astype(np.float32),
                 "pos": np.broadcast_to(
                     np.arange(SEQ, dtype=np.int32)[:, None],
                     lead + (SEQ, 3)).copy(),
                 "labels": b["labels"]}
        out.append(b)
    return out


def _torch(batch: dict, rows: range | None = None) -> dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
           batch.items()}
    out = {k: v.to(torch.int64) if v.dtype == torch.int32 else v
           for k, v in out.items()}
    if rows is not None:
        out = {k: v[rows.start:rows.stop] for k, v in out.items()}
    return out


def _times() -> list[float]:
    sched = warmup_linear_decay(0.01, 3, STEPS)
    return [float(np.float32(sched(i))) for i in range(STEPS)]


def _kw(arm: str) -> dict:
    """An arm's switches: its compressors, then any ``+placement``."""
    base, _, place = arm.partition("+")
    kw = {"two_way": TWO_WAY, "identity": IDENTITY, "natural": NATURAL}[base]
    return dict(kw, **PLACEMENTS[place]) if place else kw


def _one_arm(arm: str) -> str:
    """The one-process run an arm is held against (the placements change
    nothing without a group)."""
    return arm.partition("+")[0]


def _trainer(name: str, arm: str, group=None, mesh=None) -> Trainer:
    return Trainer(build_model(_cfgs(name)[0]), TrainerConfig(**_kw(arm)),
                   device="cpu", group=group, mesh=mesh)


def _init_state(tr: Trainer, params) -> dict:
    """The one-rank state around ``params`` (whole)."""
    return tr.opt.init(torch.Generator().manual_seed(0), params, tr.metas)


def _leaves(tree) -> list:
    from repro_torch.dist.layerwise import tree_leaves
    return tree_leaves(tree)


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_clone(v) for v in tree]
    return tree


def _digest(tree) -> str:
    h = hashlib.sha256()
    for t in _leaves(tree):
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _state_digest(state: dict) -> str:
    """A digest of every tensor of an optimizer state, shapes included,
    in key order."""
    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, torch.Tensor):
            h.update(str(tuple(t.shape)).encode())
            h.update(t.contiguous().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(state)
    return h.hexdigest()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _rel_elem(got, want) -> float:
    """max over entries of |got - want| / (1 + |want|)."""
    return max(float(((a.double() - b.double()).abs()
                      / (1 + b.double().abs())).max())
               for a, b in zip(_leaves(got), _leaves(want)))


def _one_process(name: str, arm: str, params_np) -> dict:
    """One process's run: 3 steps from the state around the reference's
    params; step 0's loss and gradients per worker; the state after step
    1 and 2 and the gradients the step from 1 to 2 used."""
    from repro_torch.dist.layerwise import leaf_paths
    tr = _trainer(name, arm)
    cfg = _cfgs(name)[0]
    batches = _batches(cfg)
    times = _times()
    state = _init_state(tr, params_from_jax(params_np))
    plan = tr.layer_plan()
    grads0, loss0 = [], []
    for j in range(N_WORKERS):
        loss, g = tr._grad_and_loss(state["x"], {
            k: v[j] for k, v in _torch(batches[0]).items()})
        grads0.append(plan.flatten(g))
        loss0.append(float(loss))
    out = {"state0": state, "grads0": grads0, "loss0": loss0,
           "paths": leaf_paths(state["x"])}
    step = tr.make_step()
    losses, used = [], []
    plain = tr._grad_and_loss

    def recorded(params, batch_slice):
        loss, g = plain(params, batch_slice)
        used.append((float(loss), plan.flatten(g)))
        return loss, g

    for i in range(STEPS):
        if i == 1:
            out["state1"] = state
            tr._grad_and_loss = recorded
        state, aux = step(state, _torch(batches[i]), times[i])
        tr._grad_and_loss = plain
        if i == 1:
            out["state2"] = {k: state[k] for k in ("x", "w", "g_server")
                             if k in state}
            out["grads1"] = used
        losses.append(float(aux["loss"]))
    out["losses"] = losses
    return out


# ------------------------------------------------------------------ ranks


def _chunk_grads(tr, plan, grads):
    return plan.unflatten([g if tr.cuts is None else tr.cuts.cut(i, g)
                           for i, g in enumerate(grads)])


def _whole(tr, plan, tree):
    from repro_torch.dist.sharding import gather_shards
    leaves = plan.flatten(tree)
    if tr.cuts is None:
        return leaves
    return [t if d is None else gather_shards(t, d, tr.rm.model_group)
            for t, d in zip(leaves, tr.cuts.dims)]


def _budget(tr) -> tuple[list, list]:
    from repro_torch.core.muon import resolve_stage_plan
    from repro_torch.dist.pipeline import s2w_issue_order
    b = tr.wire_budget()
    plan = tr.layer_plan()
    splan = resolve_stage_plan(tr.opt.cfg, plan, mesh=tr._bucket_mesh())
    order = s2w_issue_order(plan, splan) if splan is not None else (0,)
    s2w = [b.s2w_sizes[k] for k in order] if b.pack_s2w else []
    return [tr.n_local * s for s in b.w2s_sizes], s2w


def _compressor_in_bytes(tr, arm: str) -> int:
    """The bytes a rank sends a step gathering the compressors' inputs:
    its chunk of every cut leaf in the wire dtype (f32 for the lossless
    identity), once for each of its workers and, with a compressing s2w
    leg, once for the server's message."""
    if tr.cuts is None:
        return 0
    from repro_torch.dist.sharding import spec_shape
    kw = _kw(arm)
    per = (tr.n_local * (4 if kw["w2s"] == "identity" else 2)
           + (0 if kw["s2w"] == "identity" else 2))
    return sum(int(np.prod(spec_shape(s, sp, tr.mesh))) * per
               for s, sp, d in zip(tr.cuts.shapes, tr.cuts.specs,
                                   tr.cuts.dims) if d is not None)


def _case(name, d, m, arm, inp, world, tmp) -> dict:
    from repro_torch.dist import sharding
    mesh = MeshShape(data=d, model=m)
    tr = _trainer(name, arm, world, mesh)
    plan = tr.layer_plan()
    one = inp[(name, _one_arm(arm))]
    batches, times = _batches(_cfgs(name)[0]), _times()
    res: dict = {"workers": [tr.workers.start, tr.workers.stop]}
    state = tr.place(one["state0"])
    # bytes at rest, the specs'
    specs = tr.state_specs()
    shapes = tr.opt.init(None, tr._params_shapes, tr.metas)
    res["held"] = {k: _nbytes(state[k]) for k in
                   ("x", "w", "g_server", "g_w", "m_w") if state.get(k)}
    res["spec"] = {k: sharding.spec_bytes(shapes[k], specs[k], tr.mesh)
                   for k in res["held"]}
    res["whole"] = {k: _nbytes(shapes[k]) for k in res["held"]}
    # the rank's own init (its model chunks drawn, its workers' rows built
    # around them) against the cut of one process's init, the same seed
    res["init_digest"] = _state_digest(tr.init(1))
    res["init_want"] = _state_digest(tr.place(_trainer(name, arm).init(1)))
    # three steps; step 0's loss and gradients of this rank's workers
    # (at W = X), gathered whole, against one process's
    step = tr.make_step()
    plain, seen = tr._grad_and_loss, []

    def recorded(params, batch_slice):
        loss, g = plain(params, batch_slice)
        seen.append((float(loss), _whole(tr, plan, g)))
        return loss, g

    losses = []
    if tr.rm is not None:
        tr.rm.record.clear()
    for i in range(STEPS):
        tr._grad_and_loss = recorded if i == 0 else plain
        state, aux = step(state, _torch(batches[i], tr.workers), times[i])
        losses.append(float(aux["loss"]))
    gerr, lerr = [], []
    for j, (loss, got) in zip(tr.workers, seen):
        want = one["grads0"][j]
        gerr.append(max(float((a - w).abs().max())
                        / (1 + float(w.abs().max()))
                        for a, w in zip(got, want)))
        lerr.append(abs(loss - one["loss0"][j]) / (1 + abs(one["loss0"][j])))
    res["grad_err"], res["loss0_err"] = max(gerr), max(lerr)
    res["losses"] = losses
    res["gathered"] = list(tr.gathered)
    res["broadcast"] = list(tr.broadcast_bytes)
    res["budget"] = _budget(tr)
    rec = tr.rm.record if tr.rm is not None else []
    res["tags"] = sorted({r[0] for r in rec})
    res["compressor_in_bytes"] = sum(r[1] for r in rec
                                     if r[0] == "compressor_in") / STEPS
    res["compressor_in_want"] = _compressor_in_bytes(tr, arm)
    whole = tr.gather_server(state)
    res["digest"] = _digest({k: whole[k] for k in ("x", "w", "g_server")
                             if k in whole})
    if (name, m, arm) in GROUP_PATH:
        # the group path without a mesh, from the same state
        tg = _trainer(name, arm, world)
        sg = tg.place(one["state0"])
        fg = tg.make_step()
        lg = []
        for i in range(STEPS):
            sg, aux = fg(sg, _torch(batches[i], tg.workers), times[i])
            lg.append(float(aux["loss"]))
        res["group_losses"] = lg
        res["group_digest"] = _digest({k: sg[k] for k in
                                       ("x", "w", "g_server") if k in sg})
    # one step from one process's state after step 1, fed its gradients
    calls = iter(tr.workers)

    def fed(params, batch_slice):
        loss, g = one["grads1"][next(calls)]
        return torch.tensor(loss), _chunk_grads(tr, plan, g)

    if (name, (d, m), arm) == REF_CASE:
        # step 1 of REF_STEP_ARM from one process's state after step 0 on
        # the ranks' own gradients, as the reference's mesh takes it
        ref = _trainer(name, REF_STEP_ARM, world, mesh)
        sr, aux = ref.make_step()(ref.place(_clone(one["state1"])),
                                  _torch(batches[1], ref.workers), times[1])
        xr = ref.gather_server(sr)["x"]
        res["step1"] = {"loss": float(aux["loss"]), "x": _digest(xr)}
        if ref.rm.coords == {"pod": 0, "data": 0, "model": 0}:
            torch.save(xr, os.path.join(tmp, "x_step1.pt"))
    tr._grad_and_loss = fed
    s2, _ = step(tr.place(one["state1"]), _torch(batches[1], tr.workers),
                 times[1])
    s2 = tr.gather_server(s2)
    res["carried_err"] = {k: _rel_elem(s2[k], one["state2"][k])
                          for k in one["state2"]}
    if name == "nanogpt-124m" and (d, m) == (2, 2) and arm == "two_way":
        _checkpoints(_trainer(name, arm, world, mesh), one, batches, times,
                     tmp)
    return res


def _checkpoints(tr, one, batches, times, tmp) -> None:
    """Read one process's archive after step 1 and write it back; write
    this mesh's archive after step 1."""
    like = tr.place(one["state0"])
    st, k = tr.load_checkpoint(os.path.join(tmp, "ck_one"), like)
    tr.save_checkpoint(os.path.join(tmp, "ck_one_back"), st, step=k)
    st = tr.place(one["state0"])
    st, _ = tr.make_step()(st, _torch(batches[0], tr.workers), times[0])
    tr.save_checkpoint(os.path.join(tmp, "ck_mesh"), st, step=1)


def _chains(world) -> dict:
    """The column-cut chain on a rank's columns against the whole chain,
    the norms and the grams summed over the model subgroup."""
    from repro_torch.dist.sharding import RankMesh
    from repro_torch.kernels.ops import (lead_rows, newton_schulz_cols,
                                         newton_schulz_rows)
    out = {}
    for d, m in ((2, 2), (1, 4)):
        rm = RankMesh(MeshShape(data=d, model=m), world)
        g = torch.randn((4, 24, 40), generator=torch.Generator()
                        .manual_seed(3))
        rows = lead_rows(4, d, rm.data_index)
        whole = newton_schulz_rows(g)[rows.start:rows.stop] if rows \
            else newton_schulz_rows(g)
        got = newton_schulz_cols(rm.chunk(g, 2),
                                 lambda t: rm.sum_partials(t, "gram"), rows)
        out[f"{d}x{m}"] = float((got - rm.chunk(whole, 2)).abs().max())
    return out


def _rank_main(rank: int, tmp: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    results: dict = {}
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), WORLD)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=WORLD)
        inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        world = dist.group.WORLD
        for name, (d, m), arm in CASES:
            results[f"{name}/{d}x{m}/{arm}"] = _case(name, d, m, arm, inp,
                                                     world, tmp)
        results["chains"] = _chains(world)
        for what, mesh in (("size", MeshShape(data=2, model=1)),
                           ("axis", MeshShape(data=2, expert=2))):
            try:
                _trainer("nanogpt-124m", "two_way", world, mesh)
                results[f"refuses_{what}"] = None
            except (ValueError, NotImplementedError) as e:
                results[f"refuses_{what}"] = type(e).__name__ + ": " + str(e)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        results["error"] = traceback.format_exc()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


# -------------------------------------------------------------- reference


def _to_jax(tree):
    import jax.numpy as jnp
    import ml_dtypes
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if tree is None:
        return None
    a = np.asarray(tree)
    if a.dtype == np.dtype("V2"):
        a = a.view(ml_dtypes.bfloat16)
    return jnp.asarray(a)


def _jax_main(tmp: str) -> None:
    """The reference's 3-step losses of every (arch, arm) from the port's
    initial state on the same batches, one process."""
    out: dict = {}
    try:
        import jax.numpy as jnp

        from repro.models.api import build_model as jbuild_model
        from repro.train.trainer import Trainer as JTrainer
        from repro.train.trainer import TrainerConfig as JTrainerConfig
        torch.set_num_threads(1)
        with open(os.path.join(tmp, "jax_inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        for (name, arm), state in inp.items():
            jtr = JTrainer(jbuild_model(_cfgs(name)[1]), JTrainerConfig(
                remat=False, use_pallas=False, **_kw(arm)))
            step = jtr.jit_step(None)
            jstate = _to_jax(state)
            losses = []
            for b, t in zip(_batches(_cfgs(name)[1]), _times()):
                jstate, aux = step(jstate, {k: jnp.asarray(v)
                                            for k, v in b.items()},
                                   jnp.asarray(t, jnp.float32))
                losses.append(float(aux["loss"]))
            out[f"{name}/{arm}"] = losses
    except Exception:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(tmp, "jax.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process's runs here, then the ranks, the reference and the
    reference's own mesh, all at once."""
    import jax

    from repro.models.api import build_model as jbuild_model
    from repro_torch.models.api import state_to_numpy
    tmp = str(tmp_path_factory.mktemp("train_mesh"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one, jinp = {}, {}
        for name in ARCHS:
            jp, _ = jbuild_model(_cfgs(name)[1]).init(jax.random.key(0))
            jp = jax.tree.map(np.asarray, jp)
            for arm in ({ARM[name], "identity"} if name == "nanogpt-124m"
                        else {ARM[name]}):
                one[(name, arm)] = _one_process(name, arm, jp)
                jinp[(name, arm)] = state_to_numpy(one[(name, arm)]["state0"])
        torch.save(one, os.path.join(tmp, "inputs.pt"))
        with open(os.path.join(tmp, "jax_inputs.pkl"), "wb") as f:
            pickle.dump(jinp, f)
        # one process's archive after step 1, which the ranks read
        tr1 = _trainer("nanogpt-124m", "two_way")
        nano = one[("nanogpt-124m", "two_way")]
        tr1.save_checkpoint(os.path.join(tmp, "ck_one"), nano["state1"],
                            step=1)
        with open(os.path.join(tmp, "jax_mesh_in.pkl"), "wb") as f:
            g = one[("granite-3-2b", "two_way")]
            gb = _batches(_cfgs("granite-3-2b")[1])
            pickle.dump({"runs": [
                {"kw": TWO_WAY, "state": jinp[("granite-3-2b", "two_way")],
                 "batch": gb[0], "t": _times()[0]},
                {"kw": _kw(REF_STEP_ARM),
                 "state": state_to_numpy(g["state1"]), "batch": gb[1],
                 "t": _times()[1]}]}, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
            "--xla_force_host_platform_device_count=4"))
        jmesh = subprocess.Popen(
            [sys.executable, "-c", JAX_MESH_SCRIPT,
             os.path.join(tmp, "jax_mesh_in.pkl"),
             os.path.join(tmp, "jax_mesh_out.pkl")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        ctx = mp.get_context("spawn")
        ref = ctx.Process(target=_jax_main, args=(tmp,))
        ref.start()
        ranks = mp.start_processes(_rank_main, args=(tmp,), nprocs=WORLD,
                                   join=False, start_method="spawn")
        deadline = time.time() + JOIN_S
        done = False
        while not done and time.time() < deadline:
            done = ranks.join(timeout=5)
        ref.join(timeout=max(1.0, deadline - time.time()))
        try:
            _, err = jmesh.communicate(
                timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            jmesh.kill()
            _, err = jmesh.communicate()
        hung = [p.pid for p in ranks.processes if p.is_alive()]
        if ref.is_alive():
            hung.append(ref.pid)
        for p in ranks.processes + [ref]:
            if p.is_alive():
                p.kill()
        assert not hung, f"processes {hung} did not end in {JOIN_S} s"
        assert jmesh.returncode == 0, err[-3000:]
        got = {}
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                got[r] = json.load(f)
            assert "error" not in got[r], got[r]["error"]
        with open(os.path.join(tmp, "jax.json")) as f:
            jax_losses = json.load(f)
        assert "error" not in jax_losses, jax_losses["error"]
        with open(os.path.join(tmp, "jax_mesh_out.pkl"), "rb") as f:
            jax_mesh = pickle.load(f)
        yield {"tmp": tmp, "one": one, "ranks": got, "jax": jax_losses,
               "jax_mesh": jax_mesh}
    finally:
        torch.set_num_threads(n)


def _case_id(case) -> str:
    name, (d, m), arm = case
    return f"{name}-{d}x{m}-{arm}"


def _res(runs, case, r: int) -> dict:
    name, (d, m), arm = case
    return runs["ranks"][r][f"{name}/{d}x{m}/{arm}"]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_step0_loss_and_gradients_are_one_process(runs, case):
    """Each rank's step-0 loss within 1e-6 (1 + |l|) and each leaf's
    gradient, gathered whole, within 1e-5 (1 + max|g|) of one process's
    for its workers; a data row's ranks own the same workers."""
    name, (d, m), arm = case
    for r in range(WORLD):
        res = _res(runs, case, r)
        n_local = N_WORKERS // d
        assert res["workers"] == [(r // m) * n_local, (r // m + 1) * n_local]
        assert res["loss0_err"] <= LOSS_TOL, res["loss0_err"]
        assert res["grad_err"] <= GRAD_TOL, res["grad_err"]
        one0 = runs["one"][(name, _one_arm(arm))]["losses"][0]
        assert abs(res["losses"][0] - one0) <= LOSS_TOL * (1 + abs(one0))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_a_carried_step_is_one_process(runs, case):
    """One step from one process's state after step 1, fed the gradients
    that process used: x, W and g_server within 1e-5 (1 + |v|) of its
    state after step 2, on every rank."""
    for r in range(WORLD):
        errs = _res(runs, case, r)["carried_err"]
        assert errs and max(errs.values()) <= STEP_TOL, errs


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_losses_track_the_reference(runs, case):
    """The 3-step losses on every rank within ``test_torch_ranks.py``'s
    bounds of the reference's from the same state and batches (TopK
    ties move with the summation order, ROADMAP Queue 3 item 2); every
    rank of the mesh returns the same losses."""
    from test_torch_s2w import LOSS_ATOL, LOSS_ATOL_WARMUP
    name, _, arm = case
    want = runs["jax"][f"{name}/{_one_arm(arm)}"]
    first = _res(runs, case, 0)["losses"]
    for r in range(WORLD):
        got = _res(runs, case, r)["losses"]
        assert got == first
        assert all(np.isfinite(got))
        np.testing.assert_allclose(got[:2], want[:2], rtol=0,
                                   atol=LOSS_ATOL_WARMUP)
        np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if (c[0], c[1][1], c[2]) in GROUP_PATH],
                         ids=_case_id)
def test_a_model_axis_of_one_is_the_group_path(runs, case):
    """``(4, 1)``: the losses and the server's state bit-equal to the
    4-rank group without a mesh."""
    for r in range(WORLD):
        res = _res(runs, case, r)
        assert res["losses"] == res["group_losses"]
        assert res["digest"] == res["group_digest"]
        assert res["tags"] == []


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_bytes_at_rest_are_the_specs(runs, case):
    """Each rank holds the specs' bytes of x, w, g_server, g_w and m_w,
    less than whole wherever the mesh cuts."""
    _, (d, m), _ = case
    for r in range(WORLD):
        res = _res(runs, case, r)
        assert res["held"] == res["spec"]
        assert {"x", "g_server", "g_w", "m_w"} <= set(res["held"])
        if m > 1:
            assert all(res["held"][k] < res["whole"][k] for k in res["held"])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_init_is_the_cut_of_one_process(runs, case):
    """``Trainer.init`` on the mesh, which never builds a whole state, is
    bit-equal on every rank to its cut of one process's ``init`` from the
    same seed."""
    for r in range(WORLD):
        res = _res(runs, case, r)
        assert res["init_digest"] == res["init_want"]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_collectives_are_tagged_and_the_wire_is_the_budgets(runs, case):
    """Every collective of the mesh carries a training tag (no parameter
    crosses); the compressors' inputs move each rank's chunks of the cut
    leaves, once a worker and once for the server's message; the wire's
    gathers and broadcasts are the budget's per rank, every step."""
    _, (d, m), arm = case
    for r in range(WORLD):
        res = _res(runs, case, r)
        assert set(res["tags"]) <= set(TRAIN_TAGS)
        if m > 1:
            assert {"activation", "activation_grad", "logits",
                    "compressor_in", "gram"} <= set(res["tags"])
        assert res["compressor_in_bytes"] == res["compressor_in_want"]
        w2s, s2w = res["budget"]
        assert w2s and res["gathered"] == w2s * STEPS
        assert res["broadcast"] == s2w * STEPS
        assert bool(s2w) == (_kw(arm)["s2w"] != "identity")


@pytest.mark.parametrize("case", [c for c in CASES if "+" in c[2]],
                         ids=_case_id)
def test_placements_are_the_plain_mesh_run(runs, case):
    """Zero-1 and FSDP over ``(2, 2)`` (the model chunks cut over ``data``
    too): the losses and the server's state gathered whole bit-equal to
    the plain ``(2, 2)`` run's, and less held at rest."""
    name, mesh, arm = case
    for r in range(WORLD):
        res, plain = _res(runs, case, r), _res(runs, (name, mesh,
                                                      _one_arm(arm)), r)
        assert res["losses"] == plain["losses"]
        assert res["digest"] == plain["digest"]
        assert res["held"]["x"] < plain["held"]["x"]


def test_the_reference_mesh_gives_the_ports_step(runs):
    """The reference's ``Trainer`` over its own ``(2, 2)`` mesh on reduced
    granite gives the port's ``(2, 2)`` ranks' step-0 loss within 1e-6 (1
    + |l|); from one process's state after step 0 (a nonzero radius: x
    moves), the ranks' own step 1 of ``REF_STEP_ARM`` gives the
    reference's loss within 1e-6 (1 + |l|) and x, gathered whole, within
    1e-5 (1 + |v|)."""
    from repro_torch.dist.layerwise import leaf_paths, tree_get
    j0, j1 = runs["jax_mesh"]
    for r in range(WORLD):
        res = _res(runs, REF_CASE, r)
        assert abs(res["losses"][0] - j0["loss"]) \
            <= LOSS_TOL * (1 + abs(j0["loss"]))
        assert abs(res["step1"]["loss"] - j1["loss"]) \
            <= LOSS_TOL * (1 + abs(j1["loss"]))
    assert len({_res(runs, REF_CASE, r)["step1"]["x"]
                for r in range(WORLD)}) == 1
    x1 = runs["one"][("granite-3-2b", "two_way")]["state1"]["x"]
    x2 = torch.load(os.path.join(runs["tmp"], "x_step1.pt"))
    paths = leaf_paths(x1)
    before = [tree_get(x1, p).double().numpy() for p in paths]
    got = [tree_get(x2, p).double().numpy() for p in paths]
    want = [np.asarray(tree_get(j1["x"], p), np.float64) for p in paths]

    def err(a, b) -> float:
        return max(float(np.max(np.abs(u - v) / (1 + np.abs(v))))
                   for u, v in zip(a, b))

    # the step moves x by far more than the bound
    assert err(want, before) > 100 * STEP_TOL
    assert err(got, want) <= STEP_TOL, err(got, want)


def test_the_column_cut_chain_is_the_whole_chain(runs):
    """``newton_schulz_cols`` on a rank's columns, the norms and the grams
    summed over the model subgroup, within 1e-6 of the whole chain's
    columns (the plain path)."""
    for r in range(WORLD):
        errs = runs["ranks"][r]["chains"]
        assert set(errs) == {"2x2", "1x4"}
        assert max(errs.values()) <= CHAIN_TOL, errs


def test_checkpoints_move_between_the_mesh_and_one_process(runs):
    """One process's archive read by the ``(2, 2)`` ranks and written back
    is byte-equal to it; the mesh's archive after step 1, read by one
    process and written back, is byte-equal to it."""
    from repro_torch.train.checkpoint import (load_checkpoint,
                                              save_checkpoint)

    def arrays(path):
        with np.load(path + ".npz") as z:
            return {k: z[k].tobytes() for k in z.files}

    tmp = runs["tmp"]
    assert arrays(os.path.join(tmp, "ck_one")) \
        == arrays(os.path.join(tmp, "ck_one_back"))
    tr = _trainer("nanogpt-124m", "two_way")
    like = runs["one"][("nanogpt-124m", "two_way")]["state0"]
    st, k = load_checkpoint(os.path.join(tmp, "ck_mesh"), like)
    assert k == 1
    save_checkpoint(os.path.join(tmp, "ck_mesh_back"), st, step=k)
    assert arrays(os.path.join(tmp, "ck_mesh")) \
        == arrays(os.path.join(tmp, "ck_mesh_back"))
    del tr


def test_mesh_refusals(runs):
    """A mesh of another size than the group raises ValueError, and so
    does an axis other than ``pod``, ``data`` and ``model`` (a ``pod``
    axis trains since item 19: ``tests/test_torch_train_pod.py``);
    whisper, griffin and xlstm at ``model`` > 1 raise NotImplementedError
    naming item 15b, and a mesh without a group ValueError, before any
    group is needed."""
    for r in range(WORLD):
        assert runs["ranks"][r]["refuses_size"].startswith("ValueError")
        assert runs["ranks"][r]["refuses_axis"].startswith("ValueError") \
            and "'expert'" in runs["ranks"][r]["refuses_axis"]
    for arch in ("whisper-small", "recurrentgemma-2b", "xlstm-1.3b"):
        with pytest.raises(NotImplementedError, match="item 15b"):
            Trainer(build_model(get_config(arch).reduced()),
                    TrainerConfig(n_workers=2), device="cpu",
                    mesh=MeshShape(data=1, model=2))
    with pytest.raises(ValueError, match="group"):
        _trainer("nanogpt-124m", "two_way", None, MeshShape(data=2, model=2))
