"""The Mixtral MoE family of the port against the reference's.

On ``mixtral-8x7b`` (and its ``reduced()``: 2 layers, d_model 256, 4
experts of top-2, d_expert 128, f32), from the reference's parameters
and batches carried across through numpy:

  * the config field for field (published, reduced, ``with_depth``),
    the parameter tree with its metas (the experts ``[L, E, d, f]``
    with ``stack_dims=2``), the NS buckets, wire layouts and budgets;
  * ``_moe_ffn``'s output and auxiliary loss, for Mixtral's softmax
    top-2 and for a sigmoid gate with one shared expert; the same
    tokens dropped at a small capacity factor; the router's ties broken
    by the lower expert index, as ``jax.lax.top_k`` does;
  * the model's loss and every gradient leaf;
  * the EF21-Muon step from one carried state, both sides fed the
    reference model's gradients (as ``test_torch_dense_steps.py``):
    ``top10`` one way equal value for value but for ``x`` (within
    ``X_ATOL``), ``rank10+natural`` both ways equal in w, m_w and the
    server's sketches and within stated bounds elsewhere (RankK's f32
    products are summed in another order); the state through both
    packages' checkpoints, RankK's ``[n_workers, L, E, n, r]`` sketches
    included;
  * the train CLI's header.

Tolerances: f32 in another summation order: the MoE output within
``MOE_ATOL`` (1e-5, of values ~1) and its aux within rtol 1e-6; the loss
within rtol 1e-5 and each gradient leaf within 1e-4 of its scale, as the
dense family's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.launch import train as jtrain_cli
from repro.models import transformer as jtransformer
from repro.models.api import abstract_params as jabstract_params
from repro.models.api import build_model as jbuild_model
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_config
from repro_torch.core.muon import EF21Muon, EF21MuonConfig
from repro_torch.core.schedule import warmup_linear_decay
from repro_torch.dist.layerwise import leaf_paths, tree_get, tree_leaves
from repro_torch.dist.layerwise import tree_unflatten
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer
from repro_torch.models.api import (abstract_params, build_model,
                                    params_from_jax, state_from_jax,
                                    state_layout, state_to_numpy)
from repro_torch.train.checkpoint import (load_checkpoint, save_checkpoint,
                                          state_template)
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.wire.codecs import NarrowIntCodec
from test_torch_threads import one_torch_thread  # noqa: F401

ARCH = "mixtral-8x7b"
MOE_ATOL = 1e-5
X_ATOL = 1e-6         # x after NS-driven LMO steps (test_torch_s2w.py)
# the two-way rank10+natural step (test_torch_rank.py's carried step)
RANK_REL, RANK_X_ATOL = 5e-3, 1e-3
SEQ, BATCH, WORKERS = 32, 4, 2
_t = warmup_linear_decay(0.01, 3, 10)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("variant", ["full", "reduced", "depth8", "depth1"])
def test_config_matches_reference(variant):
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    if variant == "reduced":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    elif variant.startswith("depth"):
        k = int(variant[5:])
        cfg, jcfg = cfg.with_depth(k), jcfg.with_depth(k)
    for f in dataclasses.fields(cfg):
        a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name == "moe":
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    # a config with leading dense layers keeps one of them
    lead = dataclasses.replace(get_config(ARCH), moe_start_layer=3,
                               dense_ff=18432)
    jlead = dataclasses.replace(jget_config(ARCH), moe_start_layer=3,
                                dense_ff=18432)
    for c, j in ((lead.with_depth(4), jlead.with_depth(4)),
                 (lead.reduced(), jlead.reduced())):
        assert (c.n_layers, c.moe_start_layer, c.dense_ff) == \
            (j.n_layers, j.moe_start_layer, j.dense_ff)


@pytest.mark.parametrize("size", ["reduced", "full", "leading dense"])
def test_param_tree_and_metas_match_reference(size):
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    if size == "reduced":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    elif size == "leading dense":    # both stacks, a shared expert
        kw = dict(moe_start_layer=1, dense_ff=512)
        cfg = dataclasses.replace(cfg.reduced(), moe=dataclasses.replace(
            cfg.reduced().moe, n_shared=1), **kw)
        jcfg = dataclasses.replace(jcfg.reduced(), moe=dataclasses.replace(
            jcfg.reduced().moe, n_shared=1), **kw)
    jparams, jmetas = jabstract_params(jbuild_model(jcfg))
    params, metas = build_model(cfg).init(None, "meta")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jm = jax.tree.leaves(jmetas, is_leaf=lambda m: hasattr(m, "lmo"))
    assert ["/".join(p) for p in leaf_paths(params)] == \
        ["/".join(k.key for k in path) for path, _ in jflat]
    assert [(tuple(p.shape), str(p.dtype).split(".")[1])
            for p in tree_leaves(params)] == \
        [(tuple(v.shape), str(v.dtype)) for _, v in jflat]
    assert [(m.lmo, m.radius_scale, m.stack_dims, m.compressible)
            for m in tree_leaves(metas)] == \
        [(m.lmo, m.radius_scale, m.stack_dims, m.compressible) for m in jm]
    assert metas["moe_blocks"]["moe"]["e_up"].stack_dims == 2
    assert metas["moe_blocks"]["moe"]["router"].stack_dims == 1


def test_full_width_depth1_plan_equals_reference():
    """mixtral at full width and 1 layer (the smoke's training run), 2
    workers, ``top10``: its NS buckets ([24,4096,14336] for the experts,
    [2,4096,4096], [2,1024,4096], [1,8,4096]), the w2s wire and the
    budget equal the reference's; the expert slices' TopK indices go
    raw (58.7 M entries, >= 2^24), the attention's in u24, the
    router's in u16."""
    cfg, jcfg = get_config(ARCH).with_depth(1), jget_config(ARCH).with_depth(1)
    shapes, metas = abstract_params(build_model(cfg))
    jshapes, jmetas = jabstract_params(jbuild_model(jcfg))
    assert sum(p.numel() for p in tree_leaves(shapes)) == sum(
        v.size for v in jax.tree.leaves(jshapes)) == 1_713_418_240
    names = ["/".join(p) for p in leaf_paths(shapes)]
    for w2s, s2w in (("top10", "identity"), ("top10+natural", "natural")):
        kw = dict(n_workers=2, w2s=w2s, s2w=s2w)
        opt, jopt = EF21Muon(EF21MuonConfig(**kw)), JEF21Muon(
            JEF21MuonConfig(**kw))
        plan, jplan = opt.plan(shapes, metas), jopt.plan(jshapes, jmetas)
        fields = ("shape", "leaf_ids", "leaf_shapes", "transposes",
                  "counts", "radius_scales")
        got = [[getattr(b, f) for f in fields] for b in plan.ns_buckets()]
        assert got == [[getattr(b, f) for f in fields]
                       for b in jplan.ns_buckets()]
        assert sorted((sum(b.counts),) + b.shape
                      for b in plan.ns_buckets()) == sorted(
            [(24, 4096, 14336), (2, 4096, 4096), (2, 1024, 4096),
             (1, 8, 4096)])
        for direction in ("w2s", "s2w"):
            assert plan.wire_layout(torch.bfloat16, direction).describe() \
                == jplan.wire_layout(jnp.bfloat16,
                                     direction=direction).describe()
        widths = {names[i]: c.width for i, spec in enumerate(
            plan.wire_layout(torch.bfloat16).specs) for c in spec.codecs
            if isinstance(c, NarrowIntCodec)}
        if w2s == "top10":
            assert widths == {"moe_blocks/moe/router": 2, **{
                f"moe_blocks/attn/{k}": 3 for k in ("wk", "wo", "wq", "wv")}}
        b, jb = opt.wire_budget(shapes, metas), jopt.wire_budget(jshapes,
                                                                jmetas)
        assert (b.n_stages, b.w2s_sizes, b.s2w_sizes) == \
            (jb.n_stages, jb.w2s_sizes, jb.s2w_sizes)


# ----------------------------------------------------------------- _moe_ffn

@functools.lru_cache(maxsize=None)
def _layer(kind: str):
    """(reference cfg, port model, reference params of the moe stack,
    port params) for the reduced mixtral (``softmax``) or a sigmoid gate
    with one shared expert (``sigmoid``)."""
    cfg, jcfg = get_config(ARCH).reduced(), jget_config(ARCH).reduced()
    if kind == "sigmoid":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_shared=1))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, n_shared=1))
    jparams, _ = jbuild_model(jcfg).init(jax.random.key(0))
    p = _np_tree(jparams["moe_blocks"]["moe"])
    return jcfg, build_model(cfg), p, params_from_jax(p)


def _x(seed=0, shape=(2, 16, 256)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(jcfg, model, p, tp, x, l=1):
    want, jaux = jax.jit(lambda p, x: jtransformer._moe_ffn(jcfg, p, x))(
        jax.tree.map(lambda a: jnp.asarray(a[l]), p), jnp.asarray(x))
    got, aux = model._moe_ffn(tp, l, torch.from_numpy(x))
    return (got.numpy(), float(aux)), (np.asarray(want), float(jaux))


@pytest.mark.parametrize("kind", ["softmax", "sigmoid"])
def test_moe_ffn_matches_reference(kind):
    jcfg, model, p, tp = _layer(kind)
    (got, aux), (want, jaux) = _both(jcfg, model, p, tp, _x())
    np.testing.assert_allclose(got, want, rtol=0, atol=MOE_ATOL)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    assert np.abs(want).max() > 0.1


def test_moe_drops_the_same_tokens_at_small_capacity():
    """capacity_factor 0.5: 8 slots an expert for 32 tokens x top-2, so
    tokens are dropped; the dropped tokens (output exactly 0 when both
    their experts are full) and every other output equal the
    reference's."""
    jcfg, model, p, tp = _layer("softmax")
    small = dict(capacity_factor=0.5)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             **small))
    model = build_model(dataclasses.replace(model.cfg, moe=dataclasses.replace(
        model.cfg.moe, **small)))
    assert transformer.moe_capacity(model.cfg.moe, 32) == \
        jtransformer.moe_capacity(jcfg.moe, 32) == 8
    (got, _), (want, _) = _both(jcfg, model, p, tp, _x(1))
    dropped = np.all(got.reshape(32, -1) == 0, axis=1)
    assert dropped.any()
    np.testing.assert_array_equal(dropped,
                                  np.all(want.reshape(32, -1) == 0, axis=1))
    np.testing.assert_allclose(got, want, rtol=0, atol=MOE_ATOL)


def test_router_ties_take_the_lower_expert_first():
    """Equal router logits (a zero router): every token goes to experts
    0 and 1 with weight 1/2, as ``jax.lax.top_k`` orders ties; the
    capacity then drops the last tokens; and a hand-made tie row."""
    jcfg, model, p, tp = _layer("softmax")
    p = dict(p, router=np.zeros_like(p["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    (got, aux), (want, jaux) = _both(jcfg, model, p, tp, _x(2))
    np.testing.assert_allclose(got, want, rtol=0, atol=MOE_ATOL)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    # capacity ceil(2 * 32 * 1.25 / 4) = 20: tokens 20-31 are dropped
    assert np.all(got.reshape(32, -1)[20:] == 0)
    assert np.all(np.abs(got.reshape(32, -1)[:20]).max(1) > 0)
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                          [0.3, 0.1, 0.3, 0.3]])
    vals, idx = transformer._top_k(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert idx.tolist() == [[0, 1], [1, 2], [0, 2]]


# ------------------------------------------------------ loss and gradients

@functools.lru_cache(maxsize=None)
def _jmodel():
    """The reference's reduced mixtral, its initial params and metas, 3
    batches of uniform tokens (2 workers) and its compiled
    loss-and-gradient function."""
    jmodel = jbuild_model(jget_config(ARCH).reduced())
    _, jmetas = jabstract_params(jmodel)
    # compiled: the same draws as eager, in a fraction of the time
    jparams = jax.jit(lambda k: jmodel.init(k)[0])(jax.random.key(0))
    rng = np.random.default_rng(7)
    batches = [{k: jnp.asarray(rng.integers(0, 512, (
        WORKERS, BATCH // WORKERS, SEQ)), jnp.int32)
        for k in ("tokens", "labels")} for _ in range(3)]
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b, remat=False)))
    return jparams, jmetas, batches, jgrad


def test_model_loss_and_grads_match_reference():
    """Loss (cross-entropy + 0.01 x the mean aux) and every gradient leaf
    (router and experts among them) of reduced mixtral."""
    jparams, _, batches, jgrad = _jmodel()
    rng = np.random.default_rng(5)
    jparams = jax.tree.map(
        lambda v: v + jnp.asarray(0.1 * rng.standard_normal(v.shape),
                                  v.dtype)
        if np.ptp(np.asarray(v)) == 0 else v, jparams)
    jb = jax.tree.map(lambda v: v[0], batches[0])
    jloss, jgrads = jgrad(jparams, jb)
    model = build_model(get_config(ARCH).reduced())
    tr = Trainer(model, TrainerConfig(), device="cpu")
    loss, grads = tr._grad_and_loss(
        params_from_jax(_np_tree(jparams)),
        {k: torch.from_numpy(np.array(v)).to(torch.int64)
         for k, v in jb.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tree_leaves(grads))
    for path, jg in jflat:
        g = tree_get(grads, tuple(k.key for k in path))
        jg = np.asarray(jg)
        assert np.max(np.abs(jg)) > 0, path
        err = np.max(np.abs(g.numpy() - jg)) / np.max(np.abs(jg))
        assert err < 1e-4, (path, err)


# ------------------------------------------------------ the carried step

OPTS = {"top10": dict(w2s="top10", s2w="identity"),
        "rank10+natural both ways": dict(w2s="rank10+natural",
                                          s2w="rank10+natural")}


def _jnp_tree(tree):
    """numpy (bf16 as 2-byte patterns) -> jax arrays."""
    import ml_dtypes
    return jax.tree.map(lambda a: jnp.asarray(
        a.view(ml_dtypes.bfloat16) if a.dtype == np.dtype("V2") else a),
        tree)


@functools.lru_cache(maxsize=None)
def _reference_states(opt_name: str):
    """A start state (the port's init of the reference's params, RankK's
    sketches drawn by the port) and the reference's states after steps
    0, 1 and 2 from it, each step on the reference model's gradients at
    the W it reaches."""
    kw = dict(n_workers=WORKERS, beta=0.5, **OPTS[opt_name])
    jparams, jmetas, batches, jgrad = _jmodel()
    jopt = JEF21Muon(JEF21MuonConfig(use_pallas=False, **kw))
    fn = jopt.make_step(jmetas, reshard_payloads=lambda t: t,
                        reshard_updates=lambda t: t)
    jstep = jax.jit(lambda s, b, t: fn(s, lambda p, b: (b["loss"],
                                                        b["grads"]), b, t))
    _, metas = build_model(get_config(ARCH).reduced()).init(None, "meta")
    state = _jnp_tree(state_to_numpy(EF21Muon(EF21MuonConfig(**kw)).init(
        torch.Generator().manual_seed(1),
        params_from_jax(_np_tree(jparams)), metas)))
    states = [state]
    for s in range(3):
        zeros = {"loss": jnp.zeros((WORKERS,), jnp.float32),
                 "grads": jax.tree.map(
                     lambda x: jnp.zeros((WORKERS,) + x.shape, x.dtype),
                     state["x"])}
        # one way, the gradients are taken at x
        w = (jstep(state, zeros, jnp.float32(_t(s)))[0]["w"]
             if "w" in state else state["x"])
        w = jax.tree.map(lambda a, x: a.astype(x.dtype), w, state["x"])
        outs = [jgrad(w, jax.tree.map(lambda v: v[j], batches[s]))
                for j in range(WORKERS)]
        batch = {"loss": jnp.stack([o[0] for o in outs]),
                 "grads": jax.tree.map(lambda *g: jnp.stack(g),
                                       *[o[1] for o in outs])}
        state, _ = jstep(state, batch, jnp.float32(_t(s)))
        states.append(state)
    return dict(kw=kw, states=states)


def _bf16_close(a, b, share, what):
    """bf16 values: at least ``share`` of them bit-equal, every one within
    one bf16 ulp of the leaf's largest magnitude."""
    assert float(np.mean(a == b)) >= share, what
    scale = float(np.abs(b).max())
    assert float(np.abs(a - b).max()) <= 2.0 ** (
        math.ceil(math.log2(scale)) - 7), what


@pytest.mark.parametrize("opt_name", list(OPTS))
def test_step_from_carried_state_matches_reference(opt_name):
    """From the reference's state after its steps 0-1 (two-way: X != W), one
    step of the port, fed the reference model's gradients at the W it
    reaches; x within X_ATOL (the NS chain's f32 order), every leaf moved.

    top10 one way: g_w, m_w and g_server equal the reference's value for
    value. rank10+natural both ways: w, m_w and the server's sketches
    (cs_state) equal; RankK's factors are f32 products summed in
    another order than XLA's, so a few of the workers' bf16 sketches
    (cw_state) land one ulp apart, and the Natural codes of those
    factors with them: g_w and g_server within RANK_REL in Frobenius
    norm, cw_state at least 99% bit-equal and within one bf16 ulp of
    the leaf's scale, the spectral leaves' x within RANK_X_ATOL (as
    ``test_torch_rank.py``'s carried step; measured: g_w and g_server
    6.4e-4 on attn/wv, cw_state 99.87% bit-equal, x 5.1e-5)."""
    _, _, batches, jgrad = _jmodel()
    ref = _reference_states(opt_name)
    jstate, want = _np_tree(ref["states"][2]), _np_tree(ref["states"][3])
    paths = leaf_paths(jstate["x"])
    rank = opt_name.startswith("rank")
    if rank:
        assert any(np.any(a != b) for a, b in zip(
            jax.tree.leaves(jstate["x"]), jax.tree.leaves(jstate["w"])))

    def grad_and_loss(params, batch):
        jp = tree_unflatten(paths, [jnp.asarray(tree_get(params, p).numpy())
                                    for p in paths])
        loss, grads = jgrad(jp, {k: jnp.asarray(v.numpy(), jnp.int32)
                                 for k, v in batch.items()})
        return torch.tensor(float(loss)), params_from_jax(_np_tree(grads))

    _, metas = build_model(get_config(ARCH).reduced()).init(None, "meta")
    step = EF21Muon(EF21MuonConfig(**ref["kw"])).make_step(
        metas, reshard_payloads=lambda t: t, reshard_updates=lambda t: t)
    tstate = state_from_jax(jstate)
    if rank:    # the 4-D leaves' sketches: [n_w, L, E, n, r], [L, E, n, r]
        i = paths.index(("moe_blocks", "moe", "e_up"))
        assert tuple(tstate["cw_state"][i]["q"].shape[:3]) == (WORKERS, 2, 4)
        assert tuple(tstate["cs_state"][i]["q"].shape[:2]) == (2, 4)
    tstate, _ = step(tstate, grad_and_loss,
                     {k: torch.from_numpy(np.array(v)).to(torch.int64)
                      for k, v in batches[2].items()}, _t(2))
    assert tstate["step"] == int(want["step"]) == 3
    got = state_layout(tstate)
    for key in ("w", "g_w", "m_w", "g_server", "cw_state", "cs_state"):
        if key not in want:
            continue
        jflat = jax.tree_util.tree_flatten_with_path(want[key])[0]
        assert len(jflat) == len(leaf_paths(got[key]))
        for path, b in jflat:
            a = tree_get(got[key], tuple(k.key for k in path))
            a, b = a.to(torch.float32).numpy(), np.asarray(b, np.float32)
            what = f"{key}{path}"
            if rank and key in ("g_w", "g_server"):
                assert np.linalg.norm(a - b) <= RANK_REL * np.linalg.norm(
                    b), what
            elif rank and key == "cw_state":
                _bf16_close(a, b, 0.99, what)
            else:
                np.testing.assert_array_equal(a, b, err_msg=what)
    for p, meta in zip(paths, tree_leaves(metas)):
        a, b = tree_get(got["x"], p).numpy(), tree_get(want["x"], p)
        atol = RANK_X_ATOL if rank and meta.lmo == "spectral" else X_ATOL
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"x/{p}")
        assert np.any(b != tree_get(jstate["x"], p)), p


def test_mixtral_state_checkpoints_cross_both_ways(tmp_path):
    """The two-way rank10+natural state (RankK's sketches of the 4-D
    expert leaves among it) through the port's checkpoint into the
    reference and back, bit for bit."""
    jstate = _np_tree(_reference_states("rank10+natural both ways")
                      ["states"][2])
    tstate = state_from_jax(jstate)

    def same(a, b):
        fa = jax.tree_util.tree_flatten_with_path(a)[0]
        fb = jax.tree_util.tree_flatten_with_path(b)[0]
        assert [p for p, _ in fa] == [p for p, _ in fb]
        for (p, x), (_, y) in zip(fa, fb):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape, p
            np.testing.assert_array_equal(x.reshape(-1).view(np.uint8),
                                          y.reshape(-1).view(np.uint8),
                                          err_msg=str(p))

    same(state_to_numpy(tstate), jstate)
    save_checkpoint(str(tmp_path / "port"), tstate, step=2)
    back, step = jckpt.load_checkpoint(str(tmp_path / "port"), jstate)
    assert step == 2
    same(back, jstate)
    loaded, step = load_checkpoint(str(tmp_path / "port"),
                                   state_template(tstate))
    same(state_to_numpy(loaded), jstate)


def test_cli_header_equals_reference(capsys, monkeypatch):
    argv = ["--arch", ARCH, "--reduced", "--steps", "0", "--seq", "16",
            "--batch", "2", "--workers", "2", "--w2s", "top10+natural",
            "--s2w", "natural"]
    train_cli.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()[0].split()
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain_cli.main()
    theirs = capsys.readouterr().out.splitlines()[0].split()
    assert ours[-1] == "device=cpu" and ours[:-1] == theirs
