"""Training over the reference's multi-pod mesh ``(pod, data, model)``, and
the MetricSet over a cut ``model`` axis.

``Trainer(model, tcfg, device, group=g, mesh=MeshShape(pod=p, data=d,
model=m))`` puts the EF21 workers on ``pod`` and each worker's rows on
``data`` (the reference's ``worker_axis_for`` and ``batch_pspec``): a
rank runs its data index's rows of its pod's workers, and every
gradient leaf is summed over the data subgroup (``row_grad``).

On the CPU over gloo (``torch.multiprocessing``, a ``FileStore``, one
torch thread a rank), with 4 workers of 2 rows x seq 8, 3 steps, f32,
from the reference's ``model.init`` carried by ``params_from_jax``:

  * four ranks: reduced nanogpt-124m (packed ``top10+natural`` /
    ``--s2w natural``) on ``(2, 2, 1)`` and ``(2, 1, 2)``, with zero-1 and
    FSDP on ``(2, 2, 1)``; reduced mixtral-8x7b (the MoE's row gather) and
    recurrentgemma-2b (a family without a model axis) on ``(2, 2, 1)``,
    lossless workers and ``--s2w natural``; nanogpt on the ``(data,
    model)`` meshes ``(2, 2)`` and ``(1, 4)``; and the mesh ``Trainer``'s
    arms that had no test, each at ``(2, 2)``: ``--resync 2``,
    ``bernoulli(0.5)``, ``rank10`` / ``rank10+natural``, ``--donate`` and
    ``wire_stages=1``;
  * eight ranks: nanogpt on ``(2, 2, 2)``.

Every case runs with ``metrics=True``. For every case and rank:

  * step 0's loss within ``1e-6 (1 + |l|)`` of one process's, each
    gradient leaf, gathered whole, within ``1e-5 (1 + max|g|)``;
  * one step from one process's state after step 1, fed that process's
    gradients, within ``1e-5 (1 + |v|)`` of its state after step 2;
  * the 3-step losses within ``tests/test_torch_s2w.py``'s trajectory
    bounds of one process's;
  * step 0's MetricSet is one process's: the same names in the same
    order, each value within ``1e-5 (1 + |v|)``, the ``wire/`` bytes and
    the ``part/`` and ``resync/`` counts equal, ``wire/n_stages`` the
    step's own; where a ``model`` cut splits one process's NS bucket by
    its members' cuts, the split buckets' residuals (a column cut's grams
    summed over the model subgroup) average, slice-weighted, to one
    process's;
  * the bytes at rest of x, w, g_server, g_w and m_w are the specs';
  * every collective of the mesh carries a ``TRAIN_TAGS`` tag, the wire
    moves the budget's bytes over the worker axis's subgroup only (the
    ranks of a pod's (data, model) index), and the NS chains run the rows
    ``ns_bucket_pspec``'s lead gives a rank (``("pod", "data")``
    pod-major).

Beside them: the metrics-on state bit-equal to the metrics-off one at
``(2, 2)``, ``(1, 4)`` and ``(2, 2, 2)``; zero-1 and FSDP
bit-equal to the plain pod run; the reference's own ``Trainer`` on a
``(2, 2, 2)`` host-device mesh (a subprocess with 8 host devices,
``use_pallas=False``) gives the port's step-0 loss, and from one
process's state after step 0 (a nonzero radius) the ranks' own step-1
loss and x with lossless workers;
checkpoints between ``(2, 2, 1)`` and one process both ways, bit-equal;
the refusals.
"""
from __future__ import annotations

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

N_WORKERS, ROWS, SEQ, STEPS = 4, 2, 8, 3
TWO_WAY = dict(n_workers=N_WORKERS, beta=0.5, w2s="top10+natural",
               s2w="natural", metrics=True)
ARMS = {
    "two_way": TWO_WAY,
    # the workers' messages lossless (TopK's sort of every slice on
    # every data rank is most of a CPU rank's time)
    "natural": dict(TWO_WAY, w2s="identity"),
    "resync": dict(TWO_WAY, resync=2),
    "bernoulli": dict(TWO_WAY, participation="bernoulli(0.5)"),
    "rank": dict(TWO_WAY, w2s="rank10", s2w="rank10+natural"),
    "donate": dict(TWO_WAY, donate=True),
    "mono": dict(TWO_WAY, wire_stages=1),
}
# arms whose one-process run is another's (donate and one wire stage
# change no bit without a group)
ONE_ARM = {"donate": "two_way", "mono": "two_way"}
PLACEMENTS = {"zero1": {"zero1_lmo": True}, "fsdp": {"fsdp": True}}
NANO = "nanogpt-124m"
# (arch, mesh, arm): a mesh of three is (pod, data, model), of two
# (data, model)
# (in the order one process's runs come: the ranks start on a case once
# its run is there)
CASES4 = ([(NANO, (2, 2, 1), "two_way"), (NANO, (2, 1, 2), "two_way")]
          + [(NANO, (2, 2, 1), f"two_way+{p}") for p in PLACEMENTS]
          + [(NANO, (2, 2), "two_way"), (NANO, (1, 4), "two_way")]
          + [(NANO, (2, 2), a) for a in ("donate", "mono", "resync",
                                         "bernoulli", "rank")]
          + [("mixtral-8x7b", (2, 2, 1), "natural"),
             ("recurrentgemma-2b", (2, 2, 1), "natural")])
CASES8 = [(NANO, (2, 2, 2), "two_way")]
CASES = CASES4 + CASES8
# also run with the metrics off: the state must be bit-equal
METRICS_OFF = {(NANO, (2, 2), "two_way"), (NANO, (1, 4), "two_way"),
               (NANO, (2, 2, 2), "two_way")}
LOSS_TOL, GRAD_TOL, STEP_TOL, METRIC_TOL = 1e-6, 1e-5, 1e-5, 1e-5
# RankK's sketch amplifies the gradients' summation order: the bound
# ROADMAP Queue 3 item 2 gives its spectral leaves on a mesh
RANK_METRIC_TOL = 2.3e-4
# the arm of the step held against the reference's (2, 2, 2) mesh where x
# moves: its workers' messages lossless (2.4e-8 from the reference). With
# TopK, gradients within 1e-7 of the reference's pick other entries: two
# entries of a w_up slice's g_server part by 2^-11 and that slice's x by
# 3.3e-4 (1 + |v|), while the reference's own one device and meshes agree
# within 1.3e-8, and the port's ranks with its one process bit for bit
REF_STEP_ARM = "natural"
JOIN_S = 420

JAX_POD_SCRIPT = """
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
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
            ("pod", "data", "model"))
out = []
for run in inp["runs"]:
    tr = Trainer(build_model(get_config("nanogpt-124m").reduced()),
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


def _mesh(shape: tuple) -> MeshShape:
    if len(shape) == 3:
        return MeshShape(pod=shape[0], data=shape[1], model=shape[2])
    return MeshShape(data=shape[0], model=shape[1])


def _kw(arm: str) -> dict:
    base, _, place = arm.partition("+")
    return dict(ARMS[base], **PLACEMENTS[place]) if place else ARMS[base]


def _one_arm(arm: str) -> str:
    base = arm.partition("+")[0]
    return ONE_ARM.get(base, base)


def _trainer(name: str, arm: str, group=None, mesh=None,
             metrics: bool = True) -> Trainer:
    kw = dict(_kw(arm), metrics=metrics)
    return Trainer(build_model(get_config(name).reduced()),
                   TrainerConfig(**kw), device="cpu", group=group, mesh=mesh)


def _batches(cfg) -> list[dict]:
    """STEPS batches ``[N_WORKERS, ROWS, SEQ]`` as numpy arrays."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab, (N_WORKERS, ROWS, SEQ + 1)) \
            .astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


def _torch(batch: dict, rows: range | None = None) -> dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(torch.int64)
           for k, v in batch.items()}
    if rows is not None:
        out = {k: v[rows.start:rows.stop] for k, v in out.items()}
    return out


def _times() -> list[float]:
    sched = warmup_linear_decay(0.01, 3, STEPS)
    return [float(np.float32(sched(i))) for i in range(STEPS)]


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


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _rel_elem(got, want) -> float:
    """max over entries of |got - want| / (1 + |want|)."""
    return max(float(((a.double() - b.double()).abs()
                      / (1 + b.double().abs())).max())
               for a, b in zip(_leaves(got), _leaves(want)))


def _buckets(tr, mesh=None) -> list:
    """(metric name, leaf ids, slices) of each NS bucket of a step."""
    return [(f"ns/orth_residual/b{bi}_{b.shape[0]}x{b.shape[1]}",
             list(b.leaf_ids), b.batch)
            for bi, b in enumerate(tr.layer_plan().ns_buckets(mesh=mesh))]


def _one_process(name: str, arm: str, params_np) -> dict:
    """One process's run: 3 steps from the state around the reference's
    params; step 0's loss, gradients and metrics; the state after step 1
    and 2 and the gradients the step from 1 to 2 used."""
    tr = _trainer(name, arm)
    batches = _batches(get_config(name).reduced())
    times = _times()
    state = tr.opt.init(torch.Generator().manual_seed(0),
                        params_from_jax(params_np), tr.metas)
    plan = tr.layer_plan()
    grads0, loss0 = [], []
    for j in range(N_WORKERS):
        loss, g = tr._grad_and_loss(state["x"], {
            k: v[j] for k, v in _torch(batches[0]).items()})
        grads0.append(plan.flatten(g))
        loss0.append(float(loss))
    out = {"state0": state, "grads0": grads0, "loss0": loss0,
           "buckets": _buckets(tr)}
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
        if i == 0:
            out["metrics0"] = list(aux["metrics"].host_floats().items())
        if i == 1:
            out["state2"] = {k: state[k] for k in ("x", "w", "g_server")
                             if k in state}
            out["grads1"] = used
        losses.append(float(aux["loss"]))
    out["losses"] = losses
    return out


# ------------------------------------------------------------------ ranks


def _whole(tr, plan, tree) -> list:
    from repro_torch.dist.sharding import gather_shards
    return [t if d is None else gather_shards(t, d, tr.rm.model_group)
            for t, d in zip(plan.flatten(tree), tr.cuts.dims)]


def _budget(tr) -> tuple[list, list]:
    from repro_torch.core.muon import resolve_stage_plan
    from repro_torch.dist.pipeline import s2w_issue_order
    b = tr.wire_budget()
    plan = tr.layer_plan()
    splan = resolve_stage_plan(tr.opt.cfg, plan, mesh=tr._bucket_mesh())
    order = s2w_issue_order(plan, splan) if splan is not None else (0,)
    s2w = [b.s2w_sizes[k] for k in order] if b.pack_s2w else []
    return [tr.n_local * s for s in b.w2s_sizes], s2w


def _run(tr, state, batches, times, chains: list | None = None,
         steps: int = STEPS):
    """``steps`` steps; (state, losses, step-0 metrics, step-0 loss and
    gradients of each worker, gathered whole over ``model``, the digest
    of x, w and g_server gathered whole after step 0)."""
    from repro_torch.core import muon
    plan = tr.layer_plan()
    step = tr.make_step()
    plain, seen = tr._grad_and_loss, []

    def recorded(params, batch_slice):
        loss, g = plain(params, batch_slice)
        seen.append((float(loss), _whole(tr, plan, g)))
        return loss, g

    rows_fn, cols_fn = muon.newton_schulz_rows, muon.newton_schulz_cols

    def rows_rec(g, rows=None, *a, **k):
        chains.append(["rows", g.shape[0], None if rows is None
                       else [rows.start, rows.stop]])
        return rows_fn(g, rows, *a, **k)

    def cols_rec(g, s, rows=None, *a, **k):
        chains.append(["cols", g.shape[0], None if rows is None
                       else [rows.start, rows.stop]])
        return cols_fn(g, s, rows, *a, **k)

    losses, metrics0, digest0 = [], None, None
    try:
        if chains is not None:
            muon.newton_schulz_rows, muon.newton_schulz_cols = rows_rec, \
                cols_rec
        for i in range(steps):
            tr._grad_and_loss = recorded if i == 0 else plain
            state, aux = step(state, _torch(batches[i], tr.workers),
                              times[i])
            if i == 0:
                if "metrics" in aux:
                    metrics0 = list(aux["metrics"].host_floats().items())
                whole = tr.gather_server(state)
                digest0 = _digest({k: whole[k] for k in
                                   ("x", "w", "g_server") if k in whole})
            if i == 0 and chains is not None:
                muon.newton_schulz_rows, muon.newton_schulz_cols = \
                    rows_fn, cols_fn
            losses.append(float(aux["loss"]))
    finally:
        tr._grad_and_loss = plain
        muon.newton_schulz_rows, muon.newton_schulz_cols = rows_fn, cols_fn
    return state, losses, metrics0, seen, digest0


class _Inputs:
    """One process's runs as the parent writes them (one file each, in
    ``CASES`` order): a run is read once its file is there."""

    def __init__(self, tmp: str):
        self.tmp, self.runs = tmp, {}

    def __getitem__(self, key: tuple) -> dict:
        if key not in self.runs:
            path = os.path.join(self.tmp, f"one_{key[0]}_{key[1]}.pt")
            deadline = time.time() + JOIN_S
            while not os.path.exists(path) and time.time() < deadline:
                time.sleep(0.2)
            self.runs[key] = torch.load(path, weights_only=False)
        return self.runs[key]


def _one_keys() -> list:
    """(arch, one-process arm) of every case, in ``CASES`` order."""
    return list(dict.fromkeys((c[0], _one_arm(c[2])) for c in CASES))


def _case(name, shape, arm, inp, world, tmp) -> dict:
    import torch.distributed as dist

    from repro_torch.dist import sharding
    mesh = _mesh(shape)
    tr = _trainer(name, arm, world, mesh)
    plan = tr.layer_plan()
    one = inp[(name, _one_arm(arm))]
    batches, times = _batches(get_config(name).reduced()), _times()
    rm = tr.rm
    res: dict = {"workers": [tr.workers.start, tr.workers.stop],
                 "coords": [rm.pod_index, rm.data_index, rm.model_index],
                 "worker_ranks": (dist.get_process_group_ranks(
                     tr.worker_group) if tr.worker_group is not None
                     else None),
                 "n_stages": tr.wire_budget().n_stages,
                 "buckets": _buckets(tr, tr.mesh),
                 "specs": [[b.batch, list(b.pspec or ())] for b in
                           plan.ns_buckets(mesh=tr.mesh)]}
    state = tr.place(_clone(one["state0"]))
    specs = tr.state_specs()
    shapes = tr.opt.init(None, tr._params_shapes, tr.metas)
    res["held"] = {k: _nbytes(state[k]) for k in
                   ("x", "w", "g_server", "g_w", "m_w") if state.get(k)}
    res["spec"] = {k: sharding.spec_bytes(shapes[k], specs[k], tr.mesh)
                   for k in res["held"]}
    rm.record.clear()
    chains: list = []
    state, losses, metrics0, seen, res["digest0"] = _run(
        tr, state, batches, times, chains)
    res["chains"] = chains
    gerr, lerr = [], []
    for j, (loss, got) in zip(tr.workers, seen):
        want = one["grads0"][j]
        gerr.append(max(float((a - w).abs().max())
                        / (1 + float(w.abs().max()))
                        for a, w in zip(got, want)))
        lerr.append(abs(loss - one["loss0"][j]) / (1 + abs(one["loss0"][j])))
    res["grad_err"], res["loss0_err"] = max(gerr), max(lerr)
    res["losses"], res["metrics0"] = losses, metrics0
    res["gathered"] = list(tr.gathered)
    res["broadcast"] = list(tr.broadcast_bytes)
    res["budget"] = _budget(tr)
    res["tags"] = sorted({r[0] for r in rm.record})
    whole = tr.gather_server(state)
    res["digest"] = _digest({k: whole[k] for k in ("x", "w", "g_server")
                             if k in whole})
    if (name, shape, arm) in METRICS_OFF:
        off = _trainer(name, arm, world, mesh, metrics=False)
        _, _, res["metrics_off"], _, res["digest0_off"] = _run(
            off, off.place(_clone(one["state0"])), batches, times, steps=1)
    # one step from one process's state after step 1, fed its gradients
    calls = iter(tr.workers)

    def fed(params, batch_slice):
        loss, g = one["grads1"][next(calls)]
        return torch.tensor(loss), plan.unflatten(
            [tr.cuts.cut(i, t) for i, t in enumerate(g)])

    if (name, shape, arm) == CASES8[0]:
        # step 1 of REF_STEP_ARM from one process's state after step 0, on
        # the ranks' own gradients: the reference's (2, 2, 2) mesh takes
        # the same step
        ref = _trainer(name, REF_STEP_ARM, world, mesh)
        s2, aux = ref.make_step()(ref.place(_clone(one["state1"])),
                                  _torch(batches[1], ref.workers), times[1])
        x2 = ref.gather_server(s2)["x"]
        res["step1"] = {"loss": float(aux["loss"]), "x": _digest(x2)}
        if dist.get_rank() == 0:
            torch.save(x2, os.path.join(tmp, "x_step1.pt"))
    tr._grad_and_loss = fed
    s2, _ = tr.make_step()(tr.place(_clone(one["state1"])),
                           _torch(batches[1], tr.workers), times[1])
    s2 = tr.gather_server(s2)
    res["carried_err"] = {k: _rel_elem(s2[k], one["state2"][k])
                          for k in one["state2"]}
    if (name, shape, arm) == (NANO, (2, 2, 1), "two_way"):
        _checkpoints(_trainer(name, arm, world, mesh), one, batches, times,
                     tmp)
    return res


def _checkpoints(tr, one, batches, times, tmp) -> None:
    """Read one process's archive after step 1 and write it back; write
    this mesh's archive after step 1."""
    like = tr.place(_clone(one["state0"]))
    st, k = tr.load_checkpoint(os.path.join(tmp, "ck_one"), like)
    tr.save_checkpoint(os.path.join(tmp, "ck_one_back"), st, step=k)
    st = tr.place(_clone(one["state0"]))
    st, _ = tr.make_step()(st, _torch(batches[0], tr.workers), times[0])
    tr.save_checkpoint(os.path.join(tmp, "ck_mesh"), st, step=1)


def _rank_main(rank: int, tmp: str, world: int) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    results: dict = {}
    sub = os.path.join(tmp, f"w{world}")
    try:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(sub, "store"), world), rank=rank, world_size=world)
        inp = _Inputs(tmp)
        group = dist.group.WORLD
        for name, shape, arm in (CASES4 if world == 4 else CASES8):
            results[_case_id((name, shape, arm))] = _case(name, shape, arm, inp,
                                                     group, tmp)
        if world == 4:
            try:
                _trainer(NANO, "two_way", group,
                         MeshShape(pod=2, data=2, model=2))
                results["refuses_size"] = None
            except ValueError as e:
                results["refuses_size"] = str(e)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        results["error"] = traceback.format_exc()
    with open(os.path.join(sub, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks (four and eight) start first and wait for one process's
    runs, made here; then the reference's own ``(2, 2, 2)`` mesh."""
    import jax

    from repro.models.api import build_model as jbuild_model
    tmp = str(tmp_path_factory.mktemp("train_pod"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spawned = []
    try:
        for world in (4, 8):
            os.makedirs(os.path.join(tmp, f"w{world}"))
            spawned.append(mp.start_processes(
                _rank_main, args=(tmp, world), nprocs=world, join=False,
                start_method="spawn"))
        one, params, jpod = {}, {}, None
        for name, arm in _one_keys():
            if name not in params:
                jp, _ = jbuild_model(get_config(name).reduced()) \
                    .init(jax.random.key(0))
                params[name] = jax.tree.map(np.asarray, jp)
            one[(name, arm)] = _one_process(name, arm, params[name])
            if (name, arm) == (NANO, "two_way"):
                # one process's archive after step 1, which the ranks read
                _trainer(NANO, "two_way").save_checkpoint(
                    os.path.join(tmp, "ck_one"), one[(NANO, "two_way")][
                        "state1"], step=1)
            path = os.path.join(tmp, f"one_{name}_{arm}.pt")
            torch.save(one[(name, arm)], path + ".tmp")
            os.replace(path + ".tmp", path)
            if jpod is None:
                jpod = _start_reference(tmp, one[(NANO, "two_way")])
        deadline = time.time() + JOIN_S
        for ctx in spawned:
            done = False
            while not done and time.time() < deadline:
                done = ctx.join(timeout=2)
        try:
            _, err = jpod.communicate(
                timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            jpod.kill()
            _, err = jpod.communicate()
        hung = [p.pid for ctx in spawned for p in ctx.processes
                if p.is_alive()]
        assert not hung, f"processes {hung} did not end in {JOIN_S} s"
        assert jpod.returncode == 0, err[-3000:]
        got = {}
        for world in (4, 8):
            for r in range(world):
                with open(os.path.join(tmp, f"w{world}",
                                       f"rank{r}.json")) as f:
                    got[(world, r)] = json.load(f)
                assert "error" not in got[(world, r)], \
                    got[(world, r)]["error"]
        with open(os.path.join(tmp, "jax_out.pkl"), "rb") as f:
            jax_pod = pickle.load(f)
        yield {"tmp": tmp, "one": one, "ranks": got, "jax_pod": jax_pod}
    finally:
        for ctx in spawned:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        torch.set_num_threads(n)


def _start_reference(tmp: str, one: dict) -> subprocess.Popen:
    """The reference's ``(2, 2, 2)`` steps, in a subprocess with 8 host
    devices: step 0 of ``TWO_WAY`` from one process's initial state, and
    step 1 of ``REF_STEP_ARM`` from its state after step 0 (whose radius
    is not 0, so x moves)."""
    from repro_torch.models.api import state_to_numpy
    batches, times = _batches(get_config(NANO).reduced()), _times()
    runs = [{"kw": {k: v for k, v in ARMS[arm].items() if k != "metrics"},
             "state": state_to_numpy(one[f"state{i}"]),
             "batch": batches[i], "t": times[i]}
            for i, arm in ((0, "two_way"), (1, REF_STEP_ARM))]
    with open(os.path.join(tmp, "jax_in.pkl"), "wb") as f:
        pickle.dump({"runs": runs}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        "--xla_force_host_platform_device_count=8"))
    return subprocess.Popen(
        [sys.executable, "-c", JAX_POD_SCRIPT,
         os.path.join(tmp, "jax_in.pkl"), os.path.join(tmp, "jax_out.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _case_id(case) -> str:
    name, shape, arm = case
    return f"{name}-{'x'.join(map(str, shape))}-{arm}"


def _world(case) -> int:
    return 8 if case in CASES8 else 4


def _each(runs, case):
    """(rank, its result) of every rank of the case's spawn."""
    name, shape, arm = case
    world = _world(case)
    return [(r, runs["ranks"][(world, r)][_case_id(case)])
            for r in range(world)]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_step0_loss_and_gradients_are_one_process(runs, case):
    """Each rank's step-0 loss within 1e-6 (1 + |l|) of one process's and
    each leaf's gradient, gathered whole over ``model``, within 1e-5 (1 +
    max|g|); a rank owns its pod's (or data row's) workers and sits at
    the reference's row-major coordinates."""
    name, shape, arm = case
    p, d, m = shape if len(shape) == 3 else (1,) + shape
    waxis_n = p if len(shape) == 3 else d
    for r, res in _each(runs, case):
        assert res["coords"] == [r // (d * m), (r // m) % d, r % m]
        n_local = N_WORKERS // waxis_n
        w = res["coords"][0] if len(shape) == 3 else res["coords"][1]
        assert res["workers"] == [w * n_local, (w + 1) * n_local]
        assert res["loss0_err"] <= LOSS_TOL, res["loss0_err"]
        assert res["grad_err"] <= GRAD_TOL, res["grad_err"]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_a_carried_step_is_one_process(runs, case):
    """One step from one process's state after step 1, fed the gradients
    that process used: x, W and g_server within 1e-5 (1 + |v|) of its
    state after step 2, on every rank."""
    for _, res in _each(runs, case):
        errs = res["carried_err"]
        assert errs and max(errs.values()) <= STEP_TOL, errs


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_losses_track_one_process(runs, case):
    """The 3-step losses on every rank within the trajectory bounds of
    ``tests/test_torch_s2w.py`` of one process's (TopK ties and sign-LMO
    flips move with the summation order, ROADMAP Queue 3 item 2); every
    rank of the mesh returns the same losses."""
    from test_torch_s2w import LOSS_ATOL, LOSS_ATOL_WARMUP
    name, _, arm = case
    want = runs["one"][(name, _one_arm(arm))]["losses"]
    first = _each(runs, case)[0][1]["losses"]
    for _, res in _each(runs, case):
        got = res["losses"]
        assert got == first
        assert all(np.isfinite(got))
        np.testing.assert_allclose(got[:2], want[:2], rtol=0,
                                   atol=LOSS_ATOL_WARMUP)
        np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)


def _metrics_match(got: list, one: dict, mesh_buckets: list,
                   n_stages: int, tol: float = METRIC_TOL) -> None:
    """A rank's step-0 MetricSet against one process's (see the module
    docstring)."""
    def order(items) -> list:
        # the names in order, the run of residuals as one entry
        out: list = []
        for k, _ in items:
            k = "ns/" if k.startswith("ns/") else k
            if not out or out[-1] != k:
                out.append(k)
        return out

    want = dict(one["metrics0"])
    got_d = dict(got)
    assert order(got) == order(one["metrics0"])
    for k in got_d:
        if k.startswith("ns/"):
            continue
        if k == "wire/n_stages":
            assert got_d[k] == n_stages
        elif k.startswith(("wire/", "part/", "resync/")):
            assert got_d[k] == want[k], k
        else:
            assert abs(got_d[k] - want[k]) <= tol * (1 + abs(want[k])), \
                (k, got_d[k], want[k])
    covered = set()
    for name, ids, _ in one["buckets"]:
        parts = [(got_d[n], b) for n, i, b in mesh_buckets if set(i) <= set(ids)]
        assert set().union(*[set(i) for n, i, _ in mesh_buckets
                             if set(i) <= set(ids)]) == set(ids)
        covered |= {n for n, i, _ in mesh_buckets if set(i) <= set(ids)}
        mean = sum(v * b for v, b in parts) / sum(b for _, b in parts)
        assert abs(mean - want[name]) <= METRIC_TOL * (1 + abs(want[name])), \
            (name, parts, want[name])
    assert covered == {n for n, _, _ in mesh_buckets}


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_metrics_are_one_process(runs, case):
    """Step 0's MetricSet on every rank is one process's: the names in
    order, the values within 1e-5 (1 + |v|), the wire bytes and the
    participation and resync counts equal, the stage count the step's
    own, and a bucket split by its members' model cuts (a column cut's
    grams summed over the model subgroup) averaging, slice-weighted, to
    one process's residual (RankK's error norms within its bound of
    ROADMAP Queue 3 item 2)."""
    name, shape, arm = case
    one = runs["one"][(name, _one_arm(arm))]
    for _, res in _each(runs, case):
        _metrics_match(res["metrics0"], one,
                       [tuple(b) for b in res["buckets"]], res["n_stages"],
                       RANK_METRIC_TOL if arm == "rank" else METRIC_TOL)


@pytest.mark.parametrize("case", sorted(METRICS_OFF), ids=_case_id)
def test_metrics_are_pure_reads(runs, case):
    """With the metrics off the mesh's state after step 0 is bit-equal
    to the metrics-on run's, and the step returns no MetricSet."""
    for _, res in _each(runs, case):
        assert res["digest0_off"] == res["digest0"]
        assert res["metrics_off"] is None and res["metrics0"]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_bytes_at_rest_are_the_specs(runs, case):
    """Each rank holds the specs' bytes of x, w, g_server, g_w and m_w."""
    for _, res in _each(runs, case):
        assert res["held"] == res["spec"]
        assert {"x", "g_server", "g_w", "m_w"} <= set(res["held"])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_the_wire_runs_over_the_worker_axis(runs, case):
    """Every collective of the mesh carries a training tag, a pod mesh's
    row split sums its gradients over ``data`` (``row_grad``); the wire's
    gathers and broadcasts are the budget's every step, over the worker
    axis's subgroup only: on a pod mesh the ranks of the rank's (data,
    model) index."""
    name, shape, arm = case
    for r, res in _each(runs, case):
        assert set(res["tags"]) <= set(TRAIN_TAGS)
        if len(shape) == 3:
            p, d, m = shape
            assert res["worker_ranks"] == [r % (d * m) + k * d * m
                                           for k in range(p)]
            assert ("row_grad" in res["tags"]) == (d > 1)
        else:
            d, m = shape
            assert res["worker_ranks"] == (None if d == 1 else
                                           [r % m + k * m for k in range(d)])
        w2s, s2w = res["budget"]
        assert w2s and res["gathered"] == w2s * STEPS
        assert res["broadcast"] == s2w * STEPS
        assert bool(s2w) == (_kw(arm)["s2w"] != "identity")


@pytest.mark.parametrize("case", [c for c in CASES if len(c[1]) == 3],
                         ids=_case_id)
def test_the_ns_buckets_split_over_pod_and_data(runs, case):
    """A pod mesh's NS buckets lead on the slow axes ``ns_bucket_pspec``
    gives (``("pod", "data")`` where both have several ranks and divide),
    and each rank's chains run the rows of its index on them, pod-major:
    ``lead_rows(B, p d, pod d + data)``."""
    from repro_torch.kernels.ops import lead_rows
    _, (p, d, m), _ = case
    sizes = {"pod": p, "data": d, "model": m}
    for _, res in _each(runs, case):
        coords = dict(zip(("pod", "data", "model"), res["coords"]))
        leads = [sp[0] if sp else None for _, sp in res["specs"]]
        if d > 1:
            assert ["pod", "data"] in leads
        want = []
        for bsz, sp in res["specs"]:
            lead = sp[0] if sp else None
            axes = [] if lead is None else [lead] if isinstance(lead, str) \
                else lead
            n, idx = 1, 0
            for a in axes:
                n, idx = n * sizes[a], idx * sizes[a] + coords[a]
            rows = lead_rows(bsz, n, idx)
            want.append([bsz, None if rows is None
                         else [rows.start, rows.stop]])
        # the chains run in the wire's stage order
        assert sorted(c[1:] for c in res["chains"]) == sorted(want)


@pytest.mark.parametrize("case", [c for c in CASES if "+" in c[2]],
                         ids=_case_id)
def test_placements_are_the_plain_pod_run(runs, case):
    """Zero-1 and FSDP over ``(2, 2, 1)`` (the server's state cut over
    ``data``, replicated over ``pod``; with FSDP the workers' too): the
    losses and the state gathered whole bit-equal to the plain pod run's,
    and less held at rest."""
    name, shape, arm = case
    plain = dict(_each(runs, (name, shape, _one_arm(arm))))
    for r, res in _each(runs, case):
        assert res["losses"] == plain[r]["losses"]
        assert res["digest"] == plain[r]["digest"]
        assert res["held"]["x"] < plain[r]["held"]["x"]
        if arm.endswith("fsdp"):
            assert res["held"]["g_w"] < plain[r]["held"]["g_w"]


def test_the_reference_pod_mesh_gives_the_ports_step(runs):
    """The reference's ``Trainer`` over its own ``(2, 2, 2)`` mesh on
    reduced nanogpt gives the port's ``(2, 2, 2)`` ranks' step-0 loss
    within 1e-6 (1 + |l|); from one process's state after step 0 (a
    nonzero radius: x moves), the ranks' own step 1 of ``REF_STEP_ARM``
    gives the reference's loss within 1e-6 (1 + |l|) and x, gathered
    whole, within 1e-5 (1 + |v|)."""
    from repro_torch.dist.layerwise import leaf_paths, tree_get
    j0, j1 = runs["jax_pod"]
    ranks = _each(runs, CASES8[0])
    for _, res in ranks:
        assert abs(res["losses"][0] - j0["loss"]) \
            <= LOSS_TOL * (1 + abs(j0["loss"]))
        assert abs(res["step1"]["loss"] - j1["loss"]) \
            <= LOSS_TOL * (1 + abs(j1["loss"]))
    assert len({res["step1"]["x"] for _, res in ranks}) == 1
    x1 = runs["one"][(NANO, "two_way")]["state1"]["x"]
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


def test_checkpoints_move_between_the_pod_mesh_and_one_process(runs):
    """One process's archive read by the ``(2, 2, 1)`` ranks and written
    back is byte-equal to it; the mesh's archive after step 1, read by
    one process and written back, is byte-equal to it."""
    from repro_torch.train.checkpoint import (load_checkpoint,
                                              save_checkpoint)

    def arrays(path):
        with np.load(path + ".npz") as z:
            return {k: z[k].tobytes() for k in z.files}

    tmp = runs["tmp"]
    assert arrays(os.path.join(tmp, "ck_one")) \
        == arrays(os.path.join(tmp, "ck_one_back"))
    like = runs["one"][(NANO, "two_way")]["state0"]
    st, k = load_checkpoint(os.path.join(tmp, "ck_mesh"), like)
    assert k == 1
    save_checkpoint(os.path.join(tmp, "ck_mesh_back"), st, step=k)
    assert arrays(os.path.join(tmp, "ck_mesh")) \
        == arrays(os.path.join(tmp, "ck_mesh_back"))


def test_pod_refusals(runs):
    """A mesh of another size than the group raises ValueError, an
    unknown axis ValueError; a family without a model axis at ``model``
    > 1 on a pod mesh NotImplementedError naming item 15b; the ``Server``
    on a mesh with ``pod`` NotImplementedError naming item 21."""
    from repro_torch.train.serve import Server
    for r in range(4):
        assert "pod=2 x data=2 x model=2" in runs["ranks"][(4, r)][
            "refuses_size"]
    with pytest.raises(ValueError, match="'expert'"):
        _trainer(NANO, "two_way", None, MeshShape(data=2, expert=2))
    for arch in ("whisper-small", "recurrentgemma-2b", "xlstm-1.3b"):
        with pytest.raises(NotImplementedError, match="item 15b"):
            Trainer(build_model(get_config(arch).reduced()),
                    TrainerConfig(n_workers=2), device="cpu",
                    mesh=MeshShape(pod=2, data=1, model=2))
    with pytest.raises(NotImplementedError, match="item 21"):
        Server(build_model(get_config(NANO).reduced()),
               mesh=MeshShape(pod=2, data=1, model=1))
