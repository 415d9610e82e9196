"""DeepSeek-V3 in the port against the reference's.

``deepseek-v3-671b`` brings three mechanisms: multi-head latent
attention (MLA: low-rank Q and KV, a decoupled RoPE key of one head, the
latent decode cache ``c_kv``/``k_rope`` and the absorbed decode), top-8
sigmoid routing with a shared expert after leading dense layers, and the
multi-token-prediction (MTP) head. On its ``reduced()`` config (2
layers, one dense and one MoE, d_model 256, 4 heads, MLA ranks 64 / 32 /
64 / 16 / 64, 4 experts of top-2, f32) and on a reduced top-8 variant
(16 experts, top-8), from the reference's parameters and batches carried
across through numpy:

  * the configs field for field (published, reduced, ``with_depth``, the
    smoke's training cut), the parameter tree with its metas, the NS
    buckets, wire layouts and budget of the full ``with_depth(1)`` and
    of the cut (the rows ``chip_smoke.py`` asserts);
  * ``_mla_attn`` in its full, prefill and absorbed-decode modes and
    the cache it writes;
  * ``_moe_ffn`` at top-8 (and with drops), forward and gradients; the
    combine and the dispatch gather's gradient bit-equal to XLA's
    scatter-add in bf16 and to a serial loop of bf16 adds in ascending
    expert id; mixtral's top-2 bits those of PR 24's ``index_add_``;
  * ``chunked_softmax_xent`` with a mask, the MTP loss and its gradients;
  * the model's loss and every gradient leaf;
  * the two-way EF21-Muon step from a carried state, fed the reference
    model's gradients (as ``test_torch_dense_steps.py``);
  * prefill and decode logits from the port's cache and from the
    reference's (``cache_from_jax``), decode against the full forward;
  * checkpoints both ways; the train and serve CLIs' lines.

Tolerances, f32 in another summation order: attention outputs, logits
and the cache within ``ATOL`` (2e-5, ``test_torch_serve.py``'s), the MoE
output within ``MOE_ATOL`` (1e-5, ``test_torch_moe.py``'s), the loss
within rtol 1e-5 and each gradient leaf within 1e-4 of its scale (the
dense family's).
"""
from __future__ import annotations

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import serve as jserve_cli
from repro.launch import train as jtrain_cli
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro.models.api import abstract_params as jabstract_params
from repro.models.api import build_model as jbuild_model
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_config
from repro_torch.core.muon import EF21Muon, EF21MuonConfig
from repro_torch.core.schedule import warmup_linear_decay
from repro_torch.dist.layerwise import leaf_paths, tree_get, tree_leaves
from repro_torch.dist.layerwise import tree_unflatten
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import common, transformer
from repro_torch.models.api import (abstract_params, build_model,
                                    cache_from_jax, params_from_jax,
                                    state_from_jax, state_to_numpy)
from repro_torch.train.checkpoint import (load_checkpoint, save_checkpoint,
                                          state_template)
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_threads import one_torch_thread  # noqa: F401

ARCH = "deepseek-v3-671b"
ATOL = 2e-5
MOE_ATOL = 1e-5
X_ATOL = 1e-6         # x after NS-driven LMO steps (test_torch_s2w.py)
SEQ, BATCH, WORKERS = 32, 4, 2
OPT = dict(n_workers=WORKERS, beta=0.5, w2s="top10+natural", s2w="natural")
_t = warmup_linear_decay(0.01, 3, 10)
VARIANTS = ["reduced", "top8"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _top8(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=16, top_k=8))


def _cut(cfg):
    """The smoke's training cut: one dense and one MoE layer at every
    published width, 16 routed experts, vocab 32,768."""
    return dataclasses.replace(cfg.with_depth(1), vocab=32768,
                               moe=dataclasses.replace(cfg.moe,
                                                       n_experts=16))


def _cfgs(variant: str):
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    if variant == "full":
        return cfg, jcfg
    if variant == "cut":
        return _cut(cfg), _cut(jcfg)
    if variant.startswith("depth"):
        k = int(variant[5:])
        return cfg.with_depth(k), jcfg.with_depth(k)
    cfg, jcfg = cfg.reduced(), jcfg.reduced()
    if variant == "top8":
        return _top8(cfg), _top8(jcfg)
    return cfg, jcfg


@functools.lru_cache(maxsize=None)
def _reference(variant: str):
    """The reference's reduced model (``variant``), its params, metas, 3
    batches of 2 workers and its compiled loss-and-gradient function."""
    _, jcfg = _cfgs(variant)
    jmodel = jbuild_model(jcfg)
    _, jmetas = jabstract_params(jmodel)
    jparams = jax.jit(lambda k: jmodel.init(k)[0])(jax.random.key(0))
    data = JSyntheticLM(jcfg, JShapeSpec("t", "train", SEQ, BATCH),
                        n_workers=WORKERS, seed=0)
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b, remat=False)))
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, jmetas=jmetas,
                batches=[data.batch_at(s) for s in range(3)], jgrad=jgrad)


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("variant", ["full", "reduced", "depth1", "depth8",
                                     "cut"])
def test_config_matches_reference(variant):
    cfg, jcfg = _cfgs(variant)
    for f in dataclasses.fields(cfg):
        a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name in ("moe", "mla"):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    assert cfg.hd == jcfg.hd
    if variant == "reduced":
        assert dataclasses.asdict(cfg.mla) == dict(
            q_lora=64, kv_lora=32, qk_nope=64, qk_rope=16, v_dim=64)
    if variant == "cut":
        assert (cfg.n_layers, cfg.moe_start_layer, cfg.d_model, cfg.n_heads,
                cfg.dense_ff, cfg.moe.d_expert, cfg.moe.top_k,
                cfg.moe.n_shared, cfg.vocab) == (2, 1, 7168, 128, 18432,
                                                 2048, 8, 1, 32768)


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_param_tree_and_metas_match_reference(size):
    """Leaf paths in flatten order, shapes, dtypes and every meta (the
    MLA norms' sign meta, ``kv_b``'s radius scale 8 at full width and
    ``q_b``'s 4, the MTP head's block as a stack of one), at the reduced
    and the published widths (meta tensors)."""
    cfg, jcfg = _cfgs(size)
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
    assert "wq" not in params["dense_blocks"]["attn"]
    assert metas["mtp"]["block"]["attn"]["kv_b"].stack_dims == 1
    if size == "full":
        assert metas["moe_blocks"]["attn"]["kv_b"].radius_scale == 8.0
        assert metas["moe_blocks"]["attn"]["q_b"].radius_scale == 4.0
        n = sum(p.numel() for p in tree_leaves(params))
        assert n == sum(v.size for v in jax.tree.leaves(jparams))


# the NS buckets (slices, m, n) of the full with_depth(1) and of the cut
FULL_DEPTH1_BUCKETS = [(1, 256, 7168), (3, 512, 32768), (3, 576, 7168),
                       (3, 1536, 7168), (3, 1536, 24576), (771, 2048, 7168),
                       (1, 7168, 14336), (3, 7168, 16384), (6, 7168, 18432)]
CUT_BUCKETS = [(1, 16, 7168)] + FULL_DEPTH1_BUCKETS[1:5] + \
    [(51, 2048, 7168)] + FULL_DEPTH1_BUCKETS[6:]


def _budget_fields(b):
    return (b.pack_w2s, b.pack_s2w, b.n_stages, b.w2s_sizes, b.s2w_sizes,
            b.n_workers, b.two_way_nbytes)


@pytest.mark.parametrize("size, n_params, buckets", [
    ("depth1", 14_630_392_832, FULL_DEPTH1_BUCKETS),
    ("cut", 2_675_430_400, CUT_BUCKETS)])
def test_layer_plan_and_buckets_equal_reference(size, n_params, buckets):
    """The NS buckets (shapes, members, transposes, counts, radius
    scales), both wire layouts and the budget of ``top10`` one way and
    ``top10+natural`` / ``natural`` two-way (1 worker, the smoke's run)
    equal the reference's; the buckets are the rows ``chip_smoke.py``
    asserts."""
    cfg, jcfg = _cfgs(size)
    shapes, metas = abstract_params(build_model(cfg))
    jshapes, jmetas = jabstract_params(jbuild_model(jcfg))
    assert sum(p.numel() for p in tree_leaves(shapes)) == n_params
    fields = ("shape", "leaf_ids", "leaf_shapes", "transposes", "counts",
              "radius_scales")
    for w2s, s2w in (("top10", "identity"), ("top10+natural", "natural")):
        kw = dict(n_workers=1, w2s=w2s, s2w=s2w)
        opt, jopt = EF21Muon(EF21MuonConfig(**kw)), JEF21Muon(
            JEF21MuonConfig(**kw))
        plan, jplan = opt.plan(shapes, metas), jopt.plan(jshapes, jmetas)
        got = [[getattr(b, f) for f in fields] for b in plan.ns_buckets()]
        assert got == [[getattr(b, f) for f in fields]
                       for b in jplan.ns_buckets()]
        assert sorted((sum(b.counts),) + b.shape
                      for b in plan.ns_buckets()) == sorted(buckets)
        for direction in ("w2s", "s2w"):
            assert plan.wire_layout(torch.bfloat16, direction).describe() \
                == jplan.wire_layout(jnp.bfloat16,
                                     direction=direction).describe()
        assert _budget_fields(opt.wire_budget(shapes, metas)) == \
            _budget_fields(jopt.wire_budget(jshapes, jmetas))
    if size == "cut":
        import importlib.util
        from pathlib import Path
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", Path(__file__).resolve().parents[1]
            / "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        assert sorted(smoke.DEEPSEEK_BUCKETS) == sorted(buckets)


# ---------------------------------------------------------------------- MLA

@functools.lru_cache(maxsize=None)
def _mla_case():
    """The reference's reduced params, an input h [2, 12, 256], and its
    MLA attention of the MoE layer in each mode: full; prefill of the
    first 9 positions into a cache of 16; 3 decode steps after it."""
    ref = _reference("reduced")
    jcfg, jp = ref["jcfg"], ref["jparams"]
    p = jax.tree.map(lambda a: a[0], jp["moe_blocks"]["attn"])
    h = _rng(3).standard_normal((2, 12, 256)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(12)[None], (2, 12))
    full, _ = jtransformer._mla_attn(jcfg, p, jnp.asarray(h), pos, None,
                                     None, "full")
    cache = {"c_kv": jnp.zeros((2, 16, 32)), "k_rope": jnp.zeros((2, 16, 16))}
    pre, cache = jtransformer._mla_attn(jcfg, p, jnp.asarray(h[:, :9]),
                                        pos[:, :9], cache, None, "prefill")
    steps = [(np.asarray(pre), _np_tree(cache))]
    for t in range(9, 12):
        out, cache = jtransformer._mla_attn(
            jcfg, p, jnp.asarray(h[:, t:t + 1]), jnp.full((2, 1), t), cache,
            jnp.asarray(t, jnp.int32), "decode")
        steps.append((np.asarray(out), _np_tree(cache)))
    return h, np.asarray(full), steps


def test_mla_attention_three_modes_match_reference():
    """``_mla_attn`` (then ``wo``) of the MoE layer: the full mode over 12
    positions; prefill of 9 and the cache it writes (``c_kv``, the rope
    key, zeros past the prompt); 3 absorbed decode steps, each output
    and the cache after it within ATOL of the reference's; decode equal
    to the full mode's positions 9-11 within ATOL."""
    h, full, steps = _mla_case()
    model = build_model(_cfgs("reduced")[0])
    p = params_from_jax(_np_tree(_reference("reduced")["jparams"]))
    attn = p["moe_blocks"]["attn"]
    wo = attn["wo"][0]
    pos = torch.arange(12)[None]
    got = model._mla_attn(attn, 0, torch.from_numpy(h), pos, None, None,
                          "full") @ wo
    np.testing.assert_allclose(got.numpy(), full, rtol=0, atol=ATOL)
    cache = {"c_kv": torch.full((1, 2, 16, 32), 7.0),
             "k_rope": torch.full((1, 2, 16, 16), 7.0)}
    with torch.inference_mode():
        out = model._mla_attn(attn, 0, torch.from_numpy(h[:, :9]),
                              pos[:, :9], cache, None, "prefill") @ wo
        outs = [out]
        for t in range(9, 12):
            outs.append(model._mla_attn(
                attn, 0, torch.from_numpy(h[:, t:t + 1]),
                torch.full((1, 1), t), cache, t, "decode") @ wo)
            for key in ("c_kv", "k_rope"):
                np.testing.assert_allclose(
                    cache[key][0].numpy(), steps[t - 8][1][key], rtol=0,
                    atol=ATOL, err_msg=f"{key} after step {t}")
    np.testing.assert_allclose(outs[0].numpy(), steps[0][0], rtol=0,
                               atol=ATOL)
    assert bool((cache["c_kv"][0, :, 12:] == 0).all())
    for i in range(1, 4):
        np.testing.assert_allclose(outs[i].numpy(), steps[i][0], rtol=0,
                                   atol=ATOL, err_msg=f"decode {i}")
        np.testing.assert_allclose(outs[i].numpy()[:, 0], full[:, 8 + i],
                                   rtol=0, atol=ATOL)
    assert np.abs(full).max() > 0.1


def test_attention_takes_a_narrower_v():
    """MLA's v (64 wide here) against q and k of 80: equal to the
    reference's zero-padded v, sliced back, under the reference's scale
    ``1/sqrt(80)``."""
    g = _rng(4)
    q, k = (g.standard_normal((2, 20, 4, 80)).astype(np.float32)
            for _ in range(2))
    v = g.standard_normal((2, 20, 4, 64)).astype(np.float32)
    got = common.attention(*(torch.from_numpy(a) for a in (q, k, v)))
    vpad = np.pad(v, ((0, 0), (0, 0), (0, 0), (0, 16)))
    want = jcommon.attention(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(vpad), chunk_q=8, chunk_kv=8,
                             softmax_scale=1 / np.sqrt(80))
    assert tuple(got.shape) == (2, 20, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., :64],
                               rtol=0, atol=ATOL)


# ---------------------------------------------------------------------- MoE

@functools.lru_cache(maxsize=None)
def _moe_case(capacity_factor: float):
    """The reduced top-8 MoE layer at ``capacity_factor``: the reference's
    output, aux and gradients (x and every param) under one cotangent."""
    ref = _reference("top8")
    jcfg = ref["jcfg"]
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    p = jax.tree.map(lambda a: np.asarray(a[0]),
                     ref["jparams"]["moe_blocks"]["moe"])
    x = _rng(5).standard_normal((2, 16, 256)).astype(np.float32)
    cot = _rng(6).standard_normal((2, 16, 256)).astype(np.float32)

    def f(p, x):
        out, aux = jtransformer._moe_ffn(jcfg, p, x)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    return p, x, cot, np.asarray(out), float(aux), _np_tree(grads)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_top8_moe_forward_and_grads_match_reference(capacity_factor):
    """16 experts, top-8, a shared expert, 32 tokens: the output within
    MOE_ATOL, the aux within rtol 1e-6, the gradient of x and of every
    param (router, experts, shared) within 1e-4 of its scale; at
    capacity factor 0.5 (8 slots an expert for 32 x 8 assignments) the
    same assignments are dropped."""
    p, x, cot, want, jaux, (jgp, jgx) = _moe_case(capacity_factor)
    cfg = _cfgs("top8")[0]
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    model = build_model(cfg)
    tp = {k: v[None].requires_grad_() for k, v in params_from_jax(
        p).items() if not isinstance(v, dict)}
    tp["shared"] = {k: v[None].requires_grad_() for k, v in params_from_jax(
        p["shared"]).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = model._moe_ffn(tp, 0, tx)
    (torch.sum(out * torch.from_numpy(cot)) + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=MOE_ATOL)
    np.testing.assert_allclose(aux.item(), jaux, rtol=1e-6)
    cap = transformer.moe_capacity(cfg.moe, 32)
    assert cap == jtransformer.moe_capacity(cfg.moe, 32) == \
        (20 if capacity_factor == 1.25 else 8)

    def close(g, jg, what):
        err = np.abs(g - jg).max() / np.abs(jg).max()
        assert np.abs(jg).max() > 0 and err < 1e-4, (what, err)

    close(tx.grad.numpy(), jgx, "x")
    for k in ("router", "e_gate", "e_up", "e_down"):
        close(tp[k].grad[0].numpy(), jgp[k], k)
    for k in ("w_gate", "w_up", "w_down"):
        close(tp["shared"][k].grad[0].numpy(), jgp["shared"][k], k)


def _route_case(seed, n_tok=64, n_exp=16, k=8, capacity_factor=1.25):
    g = _rng(seed)
    cap = max(1, min(int(np.ceil(k * n_tok * capacity_factor / n_exp)),
                     n_tok))
    _, top = transformer._top_k(torch.from_numpy(
        g.random((n_tok, n_exp)).astype(np.float32)), k)
    r = transformer.moe_route(top, n_exp, cap)
    vals = torch.from_numpy(g.standard_normal(
        (n_exp * cap, 48)).astype(np.float32)).to(torch.bfloat16)
    return r, torch.where(r["valid"][:, None], vals, 0), top


def _serial(vals, tok, n_tok):
    """A token's rows added one bf16 add at a time in slot order (expert
    id ascending): the reference's scatter-add order."""
    out = torch.zeros((n_tok, vals.shape[1]), dtype=vals.dtype)
    for i, t in enumerate(tok.tolist()):
        out[t] = out[t] + vals[i]
    return out


def _bits(t):
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("n_exp", [16, 256])
def test_combine_and_its_gradient_add_in_expert_order(n_exp,
                                                      capacity_factor):
    """bf16, top-8: ``moe_combine`` bit-equal to XLA's ``.at[].add`` over
    the slots and to a serial loop of bf16 adds in slot order; the
    dispatch gather's gradient bit-equal to XLA's transpose of the
    gather and to the same loop. The CPU's ``index_add_`` does not give
    these bits: on bf16 it adds in f32 and rounds once (here), which the
    test pins too."""
    r, vals, _ = _route_case(n_exp, n_exp=n_exp,
                             capacity_factor=capacity_factor)
    tok = r["tok"]
    got = transformer.moe_combine(vals, r)
    serial = _serial(vals, tok, 64)
    xla = jnp.zeros((64, 48), jnp.bfloat16).at[jnp.asarray(tok.numpy())] \
        .add(jnp.asarray(vals.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(_bits(got), _bits(serial))
    np.testing.assert_array_equal(
        _bits(got), np.asarray(xla).view(np.int16))
    f32_once = torch.zeros((64, 48)).index_add_(
        0, tok, vals.float()).to(torch.bfloat16)
    np.testing.assert_array_equal(_bits(torch.zeros(
        (64, 48), dtype=torch.bfloat16).index_add_(0, tok, vals)),
        _bits(f32_once))
    assert not torch.equal(got, f32_once)
    # the dispatch's gradient: a slot's cotangent back to its token
    xf = torch.zeros((64, 48), dtype=torch.bfloat16, requires_grad=True)
    transformer.moe_dispatch(xf, r).backward(vals)
    _, vjp = jax.vjp(lambda a: a[jnp.asarray(tok.numpy())],
                     jnp.zeros((64, 48), jnp.bfloat16))
    jg, = vjp(jnp.asarray(vals.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(_bits(xf.grad), _bits(serial))
    np.testing.assert_array_equal(_bits(xf.grad),
                                  np.asarray(jg).view(np.int16))
    if capacity_factor < 1:
        assert not bool(r["kept"].all())


def test_route_tables():
    """The routing tables against their definitions: each kept
    assignment's slot holds it (``assign[pos] = a``), a valid slot's
    assignment lands back on it, a token's table row is its kept slots
    in ascending expert id, the slot weights are the routing weights
    (zero past an expert's count) and their gradient the slots'."""
    r, _, top = _route_case(1, capacity_factor=0.5)
    cap = 16                       # ceil(8 x 64 x 0.5 / 16)
    a = torch.arange(64 * 8)
    kept = r["kept"]
    assert 0 < int(kept.sum()) < 64 * 8
    assert torch.equal(r["assign"][r["pos"][kept]], a[kept])
    valid = r["valid"]
    assert int(valid.sum()) == int(kept.sum())
    assert torch.equal(r["pos"][r["assign"][valid]],
                       torch.arange(len(valid))[valid])
    tk = r["table_kept"]
    assert torch.equal((r["table"] // cap)[tk],
                       torch.sort(top, 1).values[tk])
    w = torch.rand(64, 8, requires_grad=True)
    ws = transformer.moe_slot_weights(w, r)
    assert torch.equal(ws[valid], w.reshape(-1)[r["assign"][valid]])
    assert bool((ws[~valid] == 0).all())
    ws.backward(torch.arange(len(valid), dtype=torch.float32))
    assert torch.equal(w.grad.reshape(-1),
                       torch.where(kept, r["pos"], 0).to(torch.float32))


def _pr24_moe_ffn(model, p, l, x):
    """PR 24's ``_moe_ffn``: the reference's grid and an ``index_add_``
    combine in the model's dtype."""
    moe = model.cfg.moe
    b_, s, d = x.shape
    n_tok, n_exp, k = b_ * s, moe.n_experts, moe.top_k
    cap = transformer.moe_capacity(moe, n_tok)
    xf = x.reshape(n_tok, d)
    logits = xf.to(torch.float32) @ p["router"][l].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = transformer._top_k(probs, k)
    weights = top_vals / (torch.sum(top_vals, dim=-1, keepdim=True) + 1e-9)
    a = top_idx.reshape(-1)
    order = torch.sort(a, stable=True).indices
    w_s = weights.reshape(-1)[order]
    counts = torch.bincount(a, minlength=n_exp)
    starts = torch.cumsum(counts, 0) - counts
    slots = torch.arange(cap)
    grid = torch.clamp(starts[:, None] + slots[None, :], 0, n_tok * k - 1)
    valid = slots[None, :] < counts[:, None]
    tok_ec = (order // k)[grid]
    w_ec = torch.where(valid, w_s[grid], 0.0)
    xin = xf[tok_ec]
    up = torch.bmm(xin, p["e_up"][l])
    gate = torch.bmm(xin, p["e_gate"][l])
    out_ec = torch.bmm(model._act(gate, up), p["e_down"][l])
    contrib = out_ec * w_ec[..., None].to(out_ec.dtype)
    out = torch.zeros((n_tok, d), dtype=x.dtype)
    out.index_add_(0, tok_ec.reshape(-1), contrib.reshape(-1, d))
    return out.reshape(b_, s, d)


def test_mixtral_top2_bits_unchanged():
    """Reduced mixtral in bf16 (top-2, drops at capacity 0.5 too): the
    new combine gives PR 24's ``index_add_`` bits, and so does its
    gradient of x."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              dtype="bfloat16")
    for cf in (1.25, 0.5):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        model = build_model(c)
        params, _ = model.init(torch.Generator().manual_seed(0), "cpu")
        p = params["moe_blocks"]["moe"]
        x = torch.randn(2, 16, 256, generator=torch.Generator().manual_seed(
            1)).to(torch.bfloat16)
        cot = torch.randn(2, 16, 256, generator=torch.Generator()
                          .manual_seed(2)).to(torch.bfloat16)
        grads = []
        for fn in (lambda x: model._moe_ffn(p, 1, x)[0],
                   lambda x: _pr24_moe_ffn(model, p, 1, x)):
            xr = x.clone().requires_grad_()
            out = fn(xr)
            (out * cot).sum().backward()
            grads.append((out.detach(), xr.grad))
        (a, ga), (b, gb) = grads
        np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(_bits(ga), _bits(gb))


# -------------------------------------------------------------- loss, MTP

@pytest.mark.parametrize("chunk", [1024, 8])
def test_masked_xent_matches_reference(chunk):
    g = _rng(7)
    h = g.standard_normal((3, 20, 32)).astype(np.float32)
    un = (g.standard_normal((32, 50)) / 6).astype(np.float32)
    lbl = g.integers(0, 50, (3, 20)).astype(np.int32)
    mask = g.random((3, 20)) < 0.7
    mask[1] = False
    for m in (mask, None):
        want = jcommon.chunked_softmax_xent(
            jnp.asarray(h), jnp.asarray(un), jnp.asarray(lbl),
            mask=None if m is None else jnp.asarray(m), chunk=chunk)
        got = common.chunked_softmax_xent(
            torch.from_numpy(h), torch.from_numpy(un),
            torch.from_numpy(lbl), mask=None if m is None
            else torch.from_numpy(m), chunk=chunk)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_mtp_loss_and_grads_match_reference():
    """The MTP head's loss from one hidden state h [2, 32, 256] and its
    gradients (``mtp/*``, embed, unembed and h), ``mtp/proj``'s nonzero;
    the last MTP position masked."""
    ref = _reference("reduced")
    jmodel, jp = ref["jmodel"], ref["jparams"]
    h = _rng(8).standard_normal((2, 32, 256)).astype(np.float32)
    batch = {k: np.array(v[0]) for k, v in ref["batches"][0].items()}

    def f(p, h):
        return jmodel._mtp_loss(p, h, {k: jnp.asarray(v)
                                       for k, v in batch.items()})

    jloss, (jgp, jgh) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        jp, jnp.asarray(h))
    model = build_model(_cfgs("reduced")[0])
    params = params_from_jax(_np_tree(jp))
    for v in tree_leaves(params):
        v.requires_grad_()
    th = torch.from_numpy(h).requires_grad_()
    loss = model._mtp_loss(params, th, {k: torch.from_numpy(v).long()
                                        for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    pairs = [(("h",), th.grad, jgh)] + [
        (p, tree_get(params, p).grad, tree_get(_np_tree(jgp), p))
        for p in leaf_paths(params)
        if p[0] in ("mtp", "embed", "unembed")]
    for path, g, jg in pairs:
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0, path
        err = np.abs(g.numpy() - jg).max() / np.abs(jg).max()
        assert err < 1e-4, (path, err)


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_loss_and_grads_match_reference(variant):
    """The loss (cross-entropy + 0.01 x the aux + 0.3 x MTP) and every
    gradient leaf of reduced deepseek and of its top-8 variant."""
    ref = _reference(variant)
    jb = jax.tree.map(lambda v: v[0], ref["batches"][0])
    jloss, jgrads = ref["jgrad"](ref["jparams"], jb)
    model = build_model(_cfgs(variant)[0])
    tr = Trainer(model, TrainerConfig(), device="cpu")
    loss, grads = tr._grad_and_loss(
        params_from_jax(_np_tree(ref["jparams"])),
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

@functools.lru_cache(maxsize=None)
def _reference_states():
    """The reference's two-way states after steps 0, 1 and 2 of reduced
    deepseek from init, each step on the reference model's gradients at
    the W it reaches (``test_torch_dense_steps.py``'s ``_ref_step``)."""
    ref = _reference("reduced")
    jgrad = ref["jgrad"]
    jopt = JEF21Muon(JEF21MuonConfig(use_pallas=False, **OPT))
    fn = jopt.make_step(ref["jmetas"], reshard_payloads=lambda t: t,
                        reshard_updates=lambda t: t)
    jstep = jax.jit(lambda s, b, t: fn(s, lambda p, b: (b["loss"],
                                                        b["grads"]), b, t))
    state = jopt.init(jax.random.key(1), ref["jparams"], ref["jmetas"])
    states = [state]
    for s in range(3):
        zeros = {"loss": jnp.zeros((WORKERS,), jnp.float32),
                 "grads": jax.tree.map(
                     lambda x: jnp.zeros((WORKERS,) + x.shape, x.dtype),
                     state["x"])}
        w = jstep(state, zeros, jnp.float32(_t(s)))[0]["w"]
        w = jax.tree.map(lambda a, x: a.astype(x.dtype), w, state["x"])
        outs = [jgrad(w, jax.tree.map(lambda v: v[j], ref["batches"][s]))
                for j in range(WORKERS)]
        batch = {"loss": jnp.stack([o[0] for o in outs]),
                 "grads": jax.tree.map(lambda *g: jnp.stack(g),
                                       *[o[1] for o in outs])}
        state, _ = jstep(state, batch, jnp.float32(_t(s)))
        states.append(state)
    return states


def test_two_way_step_from_carried_state_matches_reference():
    """From the reference's state after steps 0-1 (X != W), one packed
    two-way ``top10+natural`` / ``natural`` step, both sides fed the
    reference model's gradients at the W each reaches: w, g_w, m_w and
    g_server bit-equal, x within X_ATOL, every leaf moved (the MLA, MTP
    and expert leaves among them)."""
    ref = _reference("reduced")
    states = _reference_states()
    jstate, want = _np_tree(states[2]), _np_tree(states[3])
    paths = leaf_paths(jstate["x"])

    def grad_and_loss(params, batch):
        jp = tree_unflatten(paths, [jnp.asarray(tree_get(params, p).numpy())
                                    for p in paths])
        loss, grads = ref["jgrad"](jp, {k: jnp.asarray(v.numpy(), jnp.int32)
                                        for k, v in batch.items()})
        return torch.tensor(float(loss)), params_from_jax(_np_tree(grads))

    _, metas = build_model(_cfgs("reduced")[0]).init(None, "meta")
    step = EF21Muon(EF21MuonConfig(**OPT)).make_step(
        metas, reshard_payloads=lambda t: t, reshard_updates=lambda t: t)
    tstate, _ = step(state_from_jax(jstate), grad_and_loss,
                     {k: torch.from_numpy(np.array(v)).to(torch.int64)
                      for k, v in ref["batches"][2].items()}, _t(2))
    assert tstate["step"] == int(want["step"]) == 3
    for key in ("w", "g_w", "m_w", "g_server"):
        for p in paths:
            np.testing.assert_array_equal(
                tree_get(tstate[key], p).numpy(), tree_get(want[key], p),
                err_msg=f"{key}/{p}")
    for p in paths:
        got, w = tree_get(tstate["x"], p).numpy(), tree_get(want["x"], p)
        np.testing.assert_allclose(got, w, rtol=0, atol=X_ATOL,
                                   err_msg=f"x/{p}")
        assert np.any(w != tree_get(jstate["x"], p)), p


def test_state_and_checkpoints_cross_both_ways(tmp_path):
    """The two-way state (the ``mtp`` subtree and the experts' leaves
    with two stack dims among it) through ``state_to_numpy`` and through
    each package's checkpoint into the other's, bit for bit."""
    jstate = _np_tree(_reference_states()[2])
    tstate = state_from_jax(jstate)
    assert tuple(tstate["g_w"]["moe_blocks"]["moe"]["e_up"].shape) == \
        (WORKERS, 1, 4, 256, 128)
    assert "proj" in tstate["x"]["mtp"]

    def same(a, b):
        fa = jax.tree_util.tree_flatten_with_path(a)[0]
        fb = jax.tree_util.tree_flatten_with_path(b)[0]
        assert [p for p, _ in fa] == [p for p, _ in fb]
        for (p, x), (_, y) in zip(fa, fb):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape and x.dtype == y.dtype, p
            np.testing.assert_array_equal(x.reshape(-1).view(np.uint8),
                                          y.reshape(-1).view(np.uint8),
                                          err_msg=str(p))

    same(state_to_numpy(tstate), jstate)
    save_checkpoint(str(tmp_path / "port"), tstate, step=2)
    back, step = jckpt.load_checkpoint(str(tmp_path / "port"), jstate)
    assert step == 2
    same(back, jstate)
    jckpt.save_checkpoint(str(tmp_path / "ref"), jstate, step=2)
    loaded, step = load_checkpoint(str(tmp_path / "ref"),
                                   state_template(tstate))
    assert step == 2
    same(state_to_numpy(loaded), jstate)


def test_large_leaves_draw_slice_by_slice(monkeypatch):
    """A leaf of more than ``DRAW_LIMIT`` entries is drawn along its
    leading dims, each slice at most the limit, from the same generator
    in order (so the f32 draw beside deepseek's 7.5 G-entry expert stacks
    stays bounded); a smaller leaf is one draw, as before."""
    monkeypatch.setattr(common, "DRAW_LIMIT", 100)
    got, _ = common.matrix_init(torch.Generator().manual_seed(3), 4, 25,
                                torch.bfloat16, torch.device("cpu"),
                                stack=(3,))
    g = torch.Generator().manual_seed(3)
    want = torch.stack([(torch.randn((4, 25), generator=g).to(
        torch.bfloat16) * 0.5) for _ in range(3)])
    assert torch.equal(got, want)
    one, _ = common.matrix_init(torch.Generator().manual_seed(3), 4, 25,
                                torch.bfloat16, torch.device("cpu"))
    assert torch.equal(one, want[0])


# ------------------------------------------------------------------ serving

PROMPT, CAP, N_DECODE = 8, 16, 3


@functools.lru_cache(maxsize=None)
def _serve_reference(variant: str):
    """The reference's prefill of 8 tokens into a cache of 16 and 3
    decode steps after it, on its reduced params (``variant``)."""
    ref = _reference(variant)
    jm, jp = ref["jmodel"], ref["jparams"]
    toks = _rng(9).integers(0, 512, (2, PROMPT + N_DECODE)).astype(np.int32)
    logits, cache = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :PROMPT])}, jm.init_cache(2, CAP))
    out = {"tokens": toks, "prefill": (np.asarray(logits), _np_tree(cache)),
           "decode": []}
    dec = jax.jit(jm.decode_step)
    for i in range(N_DECODE):
        t = PROMPT + i
        logits, cache = dec(jp, {"token": jnp.asarray(toks[:, t:t + 1]),
                                 "t": jnp.asarray(t, jnp.int32)}, cache)
        out["decode"].append((np.asarray(logits), _np_tree(cache)))
    return out


def _caches_close(got, want):
    assert sorted(got) == sorted(want) == ["dense_blocks", "moe_blocks"]
    for name in want:
        assert sorted(got[name]) == sorted(want[name]) == ["c_kv", "k_rope"]
        for key in want[name]:
            assert tuple(got[name][key].shape) == want[name][key].shape
            np.testing.assert_allclose(got[name][key].numpy(),
                                       want[name][key], rtol=0, atol=ATOL,
                                       err_msg=f"{name}/{key}")


@pytest.mark.parametrize("source", ["port", "reference"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_and_decode_match_reference(variant, source):
    """Prefill's logits and latent cache, then 3 decode steps' logits and
    the cache after them, from the port's own cache or from the
    reference's carried in with ``cache_from_jax``."""
    ref = _serve_reference(variant)
    model = build_model(_cfgs(variant)[0])
    params = params_from_jax(_np_tree(_reference(variant)["jparams"]))
    toks = torch.from_numpy(ref["tokens"])
    logits, cache = model.prefill(params, {"tokens": toks[:, :PROMPT]},
                                  model.init_cache(2, CAP, "cpu"))
    np.testing.assert_allclose(logits.numpy(), ref["prefill"][0], rtol=0,
                               atol=ATOL)
    _caches_close(cache, ref["prefill"][1])
    if source == "reference":
        cache = cache_from_jax(ref["prefill"][1])
    for i, (want, want_cache) in enumerate(ref["decode"]):
        t = PROMPT + i
        logits, cache = model.decode_step(
            params, {"token": toks[:, t:t + 1], "t": t}, cache)
        np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=ATOL,
                                   err_msg=f"step {i}")
    _caches_close(cache, want_cache)


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_matches_the_full_forward(variant):
    """Absorbed decode at position 8 against the port's own full forward
    over 9 tokens (a no-drop capacity factor, as ``test_torch_serve.py``
    holds mixtral)."""
    cfg = _cfgs(variant)[0]
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0))
    model = build_model(cfg)
    params = params_from_jax(_np_tree(_reference(variant)["jparams"]))
    toks = torch.from_numpy(_serve_reference(variant)["tokens"][:, :9])
    _, cache = model.prefill(params, {"tokens": toks[:, :8]},
                             model.init_cache(2, CAP, "cpu"))
    got, _ = model.decode_step(params, {"token": toks[:, 8:], "t": 8},
                               cache)
    with torch.inference_mode():
        x, pos = model._embed_in(params, {"tokens": toks})
        h, _ = model._run(params, x, pos)
        want = common.logits_last(h[:, -1], model._unembed(params))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


def test_cache_spec_matches_reference_at_full_size():
    """The latent cache of the published config: ``c_kv [58, B, S, 512]``
    and ``k_rope [58, B, S, 64]`` for the MoE stack (3 dense layers
    apart), bf16, as meta tensors, 576 entries a token a layer."""
    model, jmodel = build_model(get_config(ARCH)), jbuild_model(
        jget_config(ARCH))
    cs, jcs = model.cache_spec(4, 1056), jmodel.cache_spec(4, 1056)
    for stack in jcs:
        for key, j in jcs[stack].items():
            t = cs[stack][key]
            assert t.device.type == "meta"
            assert (tuple(t.shape), str(t.dtype).split(".")[1]) == \
                (j.shape, str(j.dtype))
    assert tuple(cs["moe_blocks"]["c_kv"].shape) == (58, 4, 1056, 512)


# ---------------------------------------------------------------------- CLI

def test_cli_headers_equal_reference(capsys, monkeypatch):
    """The train CLI's header field for field (``device=`` aside), and
    the serve CLI's line but for the wall time and rate."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "0", "--seq", "16",
            "--batch", "2", "--workers", "2", "--w2s", "top10+natural",
            "--s2w", "natural"]
    train_cli.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()[0].split()
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain_cli.main()
    theirs = capsys.readouterr().out.splitlines()[0].split()
    assert ours[-1] == "device=cpu" and ours[:-1] == theirs
    assert ours[0] == f"arch={ARCH}"
    sargv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
             "8", "--max-new", "4"]
    out = serve_cli.main(sargv + ["--device", "cpu"])
    line = capsys.readouterr().out.splitlines()[1].split()
    monkeypatch.setattr(sys, "argv", ["serve"] + sargv)
    jserve_cli.main()
    jline = capsys.readouterr().out.splitlines()[0].split()
    assert line[-1] == "device=cpu"
    assert [w for w in line if not w.startswith(("wall=", "("))][:-1] == \
        [w for w in jline if not w.startswith(("wall=", "("))]
    assert tuple(out["tokens"].shape) == (2, 4)
