"""Sharded serving: ``Server(model, mesh=MeshShape(data=d, model=m),
group=g)`` over ``torch.distributed`` ranks, against one process and the
reference.

On the CPU over gloo: four processes (``torch.multiprocessing``, a
``FileStore``, one torch thread each) serve the reduced transformer
families (granite-3-2b; qwen2.5-3b with its QKV bias and tied
unembedding; starcoder2-15b at window 6, a ring; mixtral-8x7b;
deepseek-v3-671b, MLA and its latent cache; qwen2-vl-7b from an
``embeds`` prompt) on the meshes ``(2, 2)``, ``(1, 4)`` and ``(4, 1)``,
whisper-small, recurrentgemma-2b and xlstm-1.3b on ``(4, 1)``, and a
granite whose d_ff (130) 4 does not divide on ``(1, 4)``, so its
``w_up`` and ``w_gate`` take the rule's fallback cut on d_model (a
partial product and an all-reduce). Params are the reference's
``model.init`` carried by ``params_from_jax``; prompts are numpy draws
from a seed. For every case and rank:

  * the greedy tokens equal the reference ``Server``'s and the
    one-process port's;
  * prefill's and each teacher-forced decode step's f32 logits are
    within ``1e-4 (1 + |logit|)`` of the one-process port's, and
    bit-equal on every rank of a data index; xLSTM's within ``2e-3 (1 +
    |logit|)``, ``chip_smoke.py``'s bound for its card against the CPU:
    its mLSTM normaliser puts its f32 logits 2.3e-4 (1 + |logit|) from
    float64 in one process, and a rank's smaller batch rounds the
    products otherwise, as far from float64 as one process;
  * the bytes at rest of the rank's params and cache are the specs'
    (``param_pspecs``, ``serve_pspecs``) to the byte;
  * every collective carries a ``SERVE_TAGS`` tag: no parameter
    crosses;
  * temperature tokens (each rank's generator seeded apart) are equal on
    every rank of a data index.

Beside them: the reference's own ``Server(model, mesh=Mesh 2 x 2)`` on
reduced granite (a subprocess with 4 host devices) gives the port's
``(2, 2)`` tokens; the leaf-at-a-time draw gives the cuts of the
one-rank draw; the cache helpers on a leaf cut on each of its dims; the
refusals. Run with ``-s`` to print, per case, where
the logits are bit-equal to one process.
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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.train.serve import Server as JServer
from repro_torch.configs import get_config
from repro_torch.dist.sharding import (SERVE_TAGS, MeshShape, draw_shards,
                                       param_pspecs, serve_pspecs,
                                       shard_params, spec_bytes)
from repro_torch.models.api import abstract_params, build_model, \
    params_from_jax
from repro_torch.train.serve import Server
from test_torch_threads import one_torch_thread  # noqa: F401

WORLD, B, S, MAX_NEW = 4, 4, 8, 4
TOL = 1e-4
TOLS = {"xlstm-1.3b": 2e-3}
MESHES = ((2, 2), (1, 4), (4, 1))
TP_ARCHS = ("granite-3-2b", "qwen2.5-3b", "starcoder2-15b", "mixtral-8x7b",
            "deepseek-v3-671b", "qwen2-vl-7b")
DATA_ONLY = ("whisper-small", "recurrentgemma-2b", "xlstm-1.3b")
# a granite whose d_ff 4 does not divide: w_up and w_gate are cut on
# d_model, their earlier core dim
ROW_CUT = "granite-3-2b:ff130"
CASES = ([(a, m) for a in TP_ARCHS for m in MESHES]
         + [(a, (4, 1)) for a in DATA_ONLY] + [(ROW_CUT, (1, 4))])
NAMES = sorted({a for a, _ in CASES})
JOIN_S = 300

JAX_MESH_SCRIPT = """
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models.api import build_model
from repro.train.serve import Server
model = build_model(get_config("granite-3-2b").reduced())
params, _ = model.init(jax.random.key(0))
prompt = np.asarray(json.loads(sys.argv[1]), np.int32)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
toks = Server(model, mesh=mesh).generate(params, {"tokens": prompt},
                                          int(sys.argv[2]))
print(json.dumps(np.asarray(toks).tolist()))
"""


def _cfgs(name: str):
    arch, _, variant = name.partition(":")
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    kw = {}
    if arch == "starcoder2-15b":
        kw = {"window": 6}
    if variant == "ff130":
        kw = {"d_ff": 130}
    return dataclasses.replace(cfg, **kw), dataclasses.replace(jcfg, **kw)


def _prompt(cfg) -> dict:
    """The prompt as numpy arrays, from a seed."""
    rng = np.random.default_rng(1)
    if cfg.family == "vlm":
        return {"embeds": (rng.standard_normal((B, S, cfg.d_model)) * 0.02
                           ).astype(np.float32),
                "pos": rng.integers(0, S, (B, S, 3)).astype(np.int32)}
    if cfg.family == "audio":
        return {"frames": (rng.standard_normal(
                    (B, cfg.encoder.n_frames, cfg.d_model)) * 0.02
                ).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (B, 4)).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def _prompt_len(prompt: dict) -> int:
    return (prompt["tokens"] if "tokens" in prompt
            else prompt["embeds"]).shape[1]


def _torch(prompt: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in prompt.items()}


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _forced(srv: Server, params, prompt: dict, toks: torch.Tensor):
    """Prefill's logits and MAX_NEW decode steps' fed ``toks`` (the
    one-process greedy tokens): ``[1 + MAX_NEW, rows, V]``, the rows."""
    s = _prompt_len(prompt)
    logits, state = srv.prefill(params, _torch(prompt), s + MAX_NEW)
    rows = state["rows"]
    out = [logits]
    for i in range(MAX_NEW):
        out.append(srv.decode(state, toks[rows, i:i + 1], s + i))
    return torch.stack(out), rows


def _cache_helpers(group) -> dict:
    """``RankMesh``'s cache layer helpers on a ``[L, B, cap, KVH, hd]``
    leaf cut on each of its dims over ``model=4`` (the rules cut the
    layers where a short request leaves L the largest dim, the batch
    where ``data`` has one rank): the prompt's write, a slot's write and
    the layer gathered whole equal the same on the whole tensor."""
    from repro_torch.dist.sharding import RankMesh, cut
    mesh = MeshShape(data=1, model=4)
    sm = RankMesh(mesh, group)
    gen = torch.Generator().manual_seed(7)
    shape = (8, 4, 12, 4, 8)
    out = {}
    for dim in range(5):
        spec = tuple("model" if i == dim else None for i in range(5))
        whole = torch.randn(shape, generator=gen)
        local = cut(whole, spec, mesh, sm.coords).clone()
        sm.bind("cache", {"c": local}, {"c": spec})
        layer = torch.randn(shape[1:], generator=gen)
        slot = torch.randn((shape[1],) + shape[3:], generator=gen)
        ok = True
        for l in range(shape[0]):
            whole[l] = layer
            sm.write_layer(local, l, layer)
            whole[l][:, l + 3] = slot
            sm.write_slot(local, l, l + 3, slot)
            ok &= torch.equal(sm.whole_layer(local, l), whole[l])
        ok &= torch.equal(local, cut(whole, spec, mesh, sm.coords))
        out[str(dim)] = bool(ok)
    return out


def _rank_main(rank: int, tmp: str) -> None:
    """One rank: every case, the refusals."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    results: dict = {}
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), WORLD)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=WORLD)
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        world = dist.group.WORLD
        for name, (d, m) in CASES:
            cfg, _ = _cfgs(name)
            model = build_model(cfg)
            params = params_from_jax(inputs[name]["params"])
            prompt = inputs[name]["prompt"]
            srv = Server(model, mesh=MeshShape(data=d, model=m), group=world)
            toks = srv.generate(params, _torch(prompt), MAX_NEW)
            record = list(srv._sm.record)
            one_toks = torch.from_numpy(inputs[name]["one_tokens"])
            logits, rows = _forced(srv, params, prompt, one_toks)
            local = srv.place(params)
            _, state = srv.prefill(params, _torch(prompt),
                                   _prompt_len(prompt) + MAX_NEW)
            gen = torch.Generator().manual_seed(100 + rank)
            temp = srv.generate(params, _torch(prompt), MAX_NEW,
                                temperature=1.0, generator=gen)
            np.save(os.path.join(tmp, f"logits_{name}_{d}x{m}_{rank}.npy"),
                    logits.numpy())
            results[f"{name}/{d}x{m}"] = {
                "tokens": toks.tolist(), "rows": [rows.start, rows.stop],
                "digest": _digest(logits), "coords": [srv._sm.data_index,
                                                      srv._sm.model_index],
                "param_bytes": _nbytes(local),
                "cache_bytes": _nbytes(state["cache"]),
                "tags": sorted({r[0] for r in record}),
                "timings": {k: v for k, v in srv.timings.items()
                            if k != "host_staged_s"},
                "temperature": temp.tolist()}
        results["cache_helpers"] = _cache_helpers(world)
        # a mesh of another size than the group, or with no group
        cfg, _ = _cfgs("granite-3-2b")
        for what, kw in (("size", dict(mesh=MeshShape(data=2, model=1),
                                       group=world)),
                         ("no_group", dict(mesh=MeshShape(data=2, model=2)))):
            try:
                Server(build_model(cfg), **kw)
                results[f"refuses_{what}"] = False
            except ValueError:
                results[f"refuses_{what}"] = True
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        results["error"] = traceback.format_exc()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Draw the reference's params and start the ranks and the reference
    mesh's subprocess; meanwhile run the reference's and the one-process
    port's serving here."""
    tmp = str(tmp_path_factory.mktemp("serve_mesh"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inputs, ref = {}, {}
        for name in NAMES:
            _, jcfg = _cfgs(name)
            jm = jbuild_model(jcfg)
            jp, _ = jm.init(jax.random.key(0))
            inputs[name] = {"params": _np(jp), "prompt": _prompt(jcfg)}
            ref[name] = (jm, jp)
        # the one-process port first: the ranks teacher-force its tokens
        one = {}
        for name in NAMES:
            cfg, _ = _cfgs(name)
            model = build_model(cfg)
            params = params_from_jax(inputs[name]["params"])
            toks = Server(model).generate(
                params, _torch(inputs[name]["prompt"]), MAX_NEW)
            logits, _ = _forced(Server(model), params,
                                inputs[name]["prompt"], toks)
            inputs[name]["one_tokens"] = toks.numpy()
            one[name] = {"tokens": toks.numpy(), "logits": logits.numpy()}
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
            "--xla_force_host_platform_device_count=4"))
        jmesh = subprocess.Popen(
            [sys.executable, "-c", JAX_MESH_SCRIPT,
             json.dumps(inputs["granite-3-2b"]["prompt"]["tokens"].tolist()),
             str(MAX_NEW)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        ranks = mp.start_processes(_rank_main, args=(tmp,), nprocs=WORLD,
                                   join=False, start_method="spawn")
        jtoks = {}
        for name in NAMES:
            jm, jp = ref[name]
            prompt = jax.tree.map(jnp.asarray, inputs[name]["prompt"])
            jtoks[name] = np.asarray(JServer(jm).generate(jp, prompt,
                                                          MAX_NEW))
        deadline = time.time() + JOIN_S
        done = False
        while not done and time.time() < deadline:
            done = ranks.join(timeout=5)
        try:
            out, err = jmesh.communicate(
                timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            jmesh.kill()
            out, err = jmesh.communicate()
        hung = [p.pid for p in ranks.processes if p.is_alive()]
        for p in ranks.processes:
            if p.is_alive():
                p.kill()
        assert not hung, f"processes {hung} did not end in {JOIN_S} s"
        assert jmesh.returncode == 0, err[-3000:]
        got = {}
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                got[r] = json.load(f)
            assert "error" not in got[r], got[r]["error"]
        for name, (d, m) in CASES:
            for r in range(WORLD):
                got[r][f"{name}/{d}x{m}"]["logits"] = np.load(os.path.join(
                    tmp, f"logits_{name}_{d}x{m}_{r}.npy"))
        bit = {f"{a}/{d}x{m}": all(np.array_equal(
            got[r][f"{a}/{d}x{m}"]["logits"],
            one[a]["logits"][:, slice(*got[r][f"{a}/{d}x{m}"]["rows"])])
            for r in range(WORLD)) for a, (d, m) in CASES}
        print("\nlogits bit-equal to one process:", json.dumps(bit))
        jax_mesh = json.loads(out.strip().splitlines()[-1])
        yield {"ranks": got, "one": one, "jax": jtoks,
               "jax_mesh": np.asarray(jax_mesh)}
    finally:
        torch.set_num_threads(n)


def _case_id(case) -> str:
    return f"{case[0]}-{case[1][0]}x{case[1][1]}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_greedy_tokens_are_the_references(runs, case):
    """Every rank returns every row: the reference Server's greedy tokens
    and the one-process port's."""
    name, (d, m) = case
    np.testing.assert_array_equal(runs["one"][name]["tokens"],
                                  runs["jax"][name])
    for r in range(WORLD):
        toks = np.asarray(runs["ranks"][r][f"{name}/{d}x{m}"]["tokens"])
        assert toks.shape == (B, MAX_NEW)
        np.testing.assert_array_equal(toks, runs["jax"][name])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_logits_are_one_process_within_tolerance(runs, case):
    """Prefill's and every decode step's f32 logits within 1e-4 (1 +
    |logit|) of the one-process port's rows (xLSTM's 2e-3), and bit-equal
    on every rank of a data index (each runs that index's rows)."""
    name, (d, m) = case
    want = runs["one"][name]["logits"]
    by_row: dict = {}
    for r in range(WORLD):
        got = runs["ranks"][r][f"{name}/{d}x{m}"]
        lo, hi = got["rows"]
        assert got["coords"] == [r // m, r % m]
        assert (lo, hi) == ((r // m) * B // d, (r // m + 1) * B // d)
        ref = want[:, lo:hi]
        assert got["logits"].shape == ref.shape
        assert np.all(np.abs(got["logits"] - ref)
                      <= TOLS.get(name, TOL) * (1 + np.abs(ref)))
        by_row.setdefault(r // m, set()).add(got["digest"])
    assert all(len(v) == 1 for v in by_row.values()), by_row


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_bytes_at_rest_are_the_specs(runs, case):
    """Each rank holds its chunks of the params and the cache, the
    specs' bytes to the byte (less than whole wherever a spec cuts)."""
    name, (d, m) = case
    cfg, _ = _cfgs(name)
    model = build_model(cfg)
    mesh = MeshShape(data=d, model=m)
    abstract, metas = abstract_params(model)
    want_p = spec_bytes(abstract, param_pspecs(abstract, metas, mesh), mesh)
    total = _prompt_len(_prompt(cfg)) + MAX_NEW
    spec = model.cache_spec(B, total)
    want_c = spec_bytes(spec, serve_pspecs(
        spec, B, mesh, cache_alt=model.cache_spec(B + 1, total)), mesh)
    for r in range(WORLD):
        got = runs["ranks"][r][f"{name}/{d}x{m}"]
        assert (got["param_bytes"], got["cache_bytes"]) == (want_p, want_c)
    if m > 1:
        assert want_p < _nbytes(abstract) and want_c < _nbytes(spec)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_no_parameter_crosses(runs, case):
    """Every collective is tagged as activations, expert outputs, cache
    layers, logits or tokens; on ``(4, 1)`` a dense model's ranks move
    only the tokens at the end (an MoE's rows join for the dispatch)."""
    name, (d, m) = case
    for r in range(WORLD):
        tags = set(runs["ranks"][r][f"{name}/{d}x{m}"]["tags"])
        assert tags <= set(SERVE_TAGS), tags
        if m == 1:
            moe = _cfgs(name)[0].moe is not None
            assert tags == ({"tokens", "activation"} if moe else {"tokens"})
        else:
            assert {"activation", "cache", "logits"} <= tags
            assert ("tokens" in tags) == (d > 1)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_temperature_tokens_agree_on_a_data_row(runs, case):
    """Each rank's generator is seeded apart; the model subgroup's rank 0
    draws and broadcasts, so the ranks of a data index never part."""
    name, (d, m) = case
    temp = [np.asarray(runs["ranks"][r][f"{name}/{d}x{m}"]["temperature"])
            for r in range(WORLD)]
    for r in range(WORLD):
        lo, hi = (r // m) * B // d, (r // m + 1) * B // d
        np.testing.assert_array_equal(temp[r][lo:hi],
                                      temp[(r // m) * m][lo:hi])
        assert temp[r].shape == (B, MAX_NEW)
        assert temp[r].min() >= 0 and temp[r].max() < _cfgs(name)[0].vocab


def test_reference_mesh_gives_the_ports_tokens(runs):
    """The reference's own ``Server(model, mesh=Mesh 2 x 2)`` on reduced
    granite: the port's ``(2, 2)`` tokens."""
    np.testing.assert_array_equal(
        runs["jax_mesh"],
        np.asarray(runs["ranks"][0]["granite-3-2b/2x2"]["tokens"]))


def test_cache_helpers_for_every_cut_dim(runs):
    for r in range(WORLD):
        assert runs["ranks"][r]["cache_helpers"] == {
            str(d): True for d in range(5)}


def test_mesh_refusals(runs):
    """A mesh without a group or of another size than the group raises
    ValueError; whisper, griffin and xlstm at model > 1 raise
    NotImplementedError naming item 15b, before any group is needed."""
    for r in range(WORLD):
        assert runs["ranks"][r]["refuses_size"]
        assert runs["ranks"][r]["refuses_no_group"]
    for arch in DATA_ONLY:
        with pytest.raises(NotImplementedError, match="item 15b"):
            Server(build_model(_cfgs(arch)[0]),
                   mesh=MeshShape(data=1, model=2))


def test_the_leaf_at_a_time_draw_is_the_cuts_of_one_draw():
    """``draw_shards`` keeps each rank's chunk of every leaf as it is
    drawn: equal to ``shard_params`` of the one-rank ``model.init`` from
    the same seed, at every coordinate of a (2, 2) mesh; the row-cut
    variant's ``w_up`` is cut on d_model."""
    for name in ("mixtral-8x7b", "deepseek-v3-671b", ROW_CUT):
        model = build_model(_cfgs(name)[0])
        whole, metas = model.init(torch.Generator().manual_seed(3), "cpu")
        mesh = MeshShape(data=1, model=4) if name == ROW_CUT \
            else MeshShape(data=2, model=2)
        for i in range(mesh.shape["data"]):
            for j in range(mesh.shape["model"]):
                coords = {"data": i, "model": j}
                drawn, dmetas = draw_shards(
                    model, torch.Generator().manual_seed(3), "cpu", mesh,
                    coords)
                cut = shard_params(whole, metas, mesh, coords)
                assert dmetas == metas
                flat_d = jax.tree_util.tree_leaves(drawn)
                flat_c = jax.tree_util.tree_leaves(cut)
                assert len(flat_d) == len(flat_c)
                assert all(torch.equal(a, b) for a, b in zip(flat_d, flat_c))
        if name == ROW_CUT:
            specs = param_pspecs(whole, metas, mesh)
            assert specs["dense_blocks"]["mlp"]["w_up"] == \
                (None, "model", None)
