"""The dense model family of the port against the reference's.

The four dense architectures beside nanogpt (qwen2.5-3b, granite-3-2b,
starcoder2-15b, mistral-large-123b) need RMSNorm, RoPE, SwiGLU, GQA with
fewer KV heads, QKV bias, a sliding window and an untied unembedding.
Each test runs over their ``reduced()`` configs (2 layers, d_model 256,
f32) on the reference's parameters and batches, handed over through
numpy: the configs field for field, the parameter tree and its metas,
the new primitives, the loss and every gradient leaf, and the CLI
header. The EF21-Muon step on these trees is in
``test_torch_dense_steps.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import train as jtrain_cli
from repro.models import common as jcommon
from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.dist.pipeline import s2w_issue_order as js2w_issue_order
from repro.models.api import abstract_params as jabstract_params
from repro.models.api import build_model as jbuild_model
from repro_torch.configs import ARCHS, NOT_YET_PORTED, get_config
from repro_torch.core.muon import EF21Muon, EF21MuonConfig
from repro_torch.dist.layerwise import leaf_paths, tree_leaves
from repro_torch.dist.pipeline import s2w_issue_order
from repro_torch.launch import train as train_cli
from repro_torch.models import common
from repro_torch.models.api import (abstract_params, build_model,
                                    params_from_jax)
from repro_torch.wire.codecs import NarrowIntCodec
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_threads import one_torch_thread  # noqa: F401

DENSE = ["qwen2.5-3b", "granite-3-2b", "starcoder2-15b",
         "mistral-large-123b"]
# starcoder2's reduced window is 64: a longer sequence lets it bite
SEQ, BATCH = 96, 4
ROOT = Path(__file__).resolve().parents[1]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rng(seed):
    return np.random.default_rng(seed)


@functools.lru_cache(maxsize=None)
def _jinit(arch: str):
    """The reference's reduced model and its initial params."""
    jmodel = jbuild_model(jget_config(arch).reduced())
    return jmodel, jmodel.init(jax.random.key(0))[0]


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", DENSE + ["nanogpt-124m"])
@pytest.mark.parametrize("variant", ["full", "reduced", "depth8"])
def test_config_matches_reference(arch, variant):
    """Every field of the port's config equals the reference's, for the
    published config, ``reduced()`` and ``with_depth(8)``."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    if variant == "reduced":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    elif variant == "depth8":
        cfg, jcfg = cfg.with_depth(8), jcfg.with_depth(8)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.hd == jcfg.hd


def test_registry_holds_the_dense_family():
    from repro.configs import ARCHS as JARCHS
    assert sorted(ARCHS + NOT_YET_PORTED) == sorted(JARCHS)
    assert set(DENSE + ["nanogpt-124m"]) <= set(ARCHS)
    assert all(jget_config(a).family in ("dense", "moe") for a in ARCHS)
    assert {a for a in ARCHS if jget_config(a).family == "moe"} \
        == {"mixtral-8x7b", "deepseek-v3-671b"}


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-small",
                                  "xlstm-1.3b", "deepseek-v3-671b",
                                  "recurrentgemma-2b"])
def test_other_families_name_roadmap_item_9(arch):
    """The families still to port raise and name item 9; deepseek-v3-671b,
    the first of them, is ported: its config (MLA, MTP, top-8 with a
    shared expert) builds a model."""
    if arch == "deepseek-v3-671b":
        assert arch in ARCHS and arch not in NOT_YET_PORTED
        cfg = get_config(arch)
        assert cfg.mla is not None and cfg.mtp and cfg.moe.top_k == 8
        assert build_model(cfg).n_moe == 58
        return
    assert arch in NOT_YET_PORTED
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        get_config(arch)


@pytest.mark.parametrize("field, value", [("norm", "scalenorm"),
                                          ("act", "relu"), ("rope", "mrope")])
def test_unported_features_name_roadmap_item_9(field, value):
    """A dense config with a norm, activation or rope the port lacks is
    refused, not trained as another model."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              **{field: value})
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        build_model(cfg)


def test_qwen_depth8_has_the_published_widths():
    cfg = get_config("qwen2.5-3b").with_depth(8)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab) == (8, 2048, 16, 2, 128, 11008, 151936)
    params, _ = build_model(cfg).init(None, "meta")
    jparams, _ = jabstract_params(jbuild_model(jget_config(
        "qwen2.5-3b").with_depth(8)))
    n = sum(p.numel() for p in tree_leaves(params))
    assert n == sum(v.size for v in jax.tree.leaves(jparams)) == 927_782_912


# ------------------------------------------------------- params and metas

@pytest.mark.parametrize("arch", DENSE)
def test_param_tree_and_metas_match_reference(arch):
    """Leaf paths in flatten order, shapes, dtypes and every meta
    (untied ``unembed``'s sign meta and the biases' ``compressible=False``
    among them), at the reduced and the published widths."""
    for cfg, jcfg in ((get_config(arch).reduced(),
                       jget_config(arch).reduced()),
                      (get_config(arch), jget_config(arch))):
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
            [(m.lmo, m.radius_scale, m.stack_dims, m.compressible)
             for m in jm]
    if not cfg.tied_embeddings:
        assert metas["unembed"].lmo == "sign" and metas["unembed"].compressible
    if cfg.qkv_bias:
        assert not metas["dense_blocks"]["attn"]["bq"].compressible


@pytest.mark.parametrize("arch", DENSE)
def test_init_draws_the_reference_scales(arch):
    """The port draws its own numbers; each leaf's scale is the
    reference's (norm weights 1, biases 0, fan-in std for matrices,
    0.02 for embeddings, 1/sqrt(d) for ``unembed``)."""
    cfg = get_config(arch).reduced()
    params, _ = build_model(cfg).init(torch.Generator().manual_seed(0),
                                      "cpu")
    _, jparams = _jinit(arch)
    for path, jv in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        p = params
        for k in path:
            p = p[k.key]
        jv = np.asarray(jv)
        if np.all(jv == jv.flat[0]):
            np.testing.assert_array_equal(p.numpy(), jv)
        else:
            np.testing.assert_allclose(p.std().item(), jv.std(), rtol=0.1)


# -------------------------------------------------------------- primitives

@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(eps, dtype):
    x = (_rng(1).standard_normal((3, 7, 64)) * 3).astype(np.float32)
    w = _rng(2).standard_normal(64).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    want = np.asarray(jcommon.rms_norm(jx, jw, eps).astype(jnp.float32))
    got = common.rms_norm(params_from_jax({"a": np.asarray(jx)})["a"],
                          params_from_jax({"a": np.asarray(jw)})["a"], eps)
    assert got.dtype == getattr(torch, dtype)
    # f32: summation order only; bf16: at most one rounding step
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


# RoPE in f32 at positions up to S: the angle pos * freq carries the
# rounding of the product and of base ** (-i / d2) (a few ulps: ~5 * 2^-24
# of an angle up to ~S rad), so each side is within about (|x1| + |x2|)
# times that of the float64 rotation. At S = 1024 JAX and PyTorch are an
# ulp or so apart and ~1e-4 from it, but PyTorch's CPU cos/sin now and
# then err several times more on the first call of a busy process
ROPE_ANGLE_ERR = 5 * 2 ** -24


def _rope_f64(x, pos, base):
    d2 = x.shape[-1] // 2
    freqs = base ** (-np.arange(d2, dtype=np.float64) / d2)
    angle = pos[..., None].astype(np.float64) * freqs
    cos, sin = np.cos(angle)[:, :, None], np.sin(angle)[:, :, None]
    x1, x2 = x[..., :d2].astype(np.float64), x[..., d2:].astype(np.float64)
    return np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


@pytest.mark.parametrize("base", [1e6, 1e5, 1e4])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_apply_rope_matches_reference(base, head_dim):
    """Both sides' f32 rotation against the float64 one within the
    rounding of an f32 angle, and against each other; the frequencies
    within 1e-6."""
    s = 1024
    x = _rng(3).standard_normal((2, s, 3, head_dim)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (2, s))
    want = np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         base=base))
    np.testing.assert_allclose(
        common.rope_freqs(head_dim, base).numpy(),
        np.asarray(jcommon.rope_freqs(head_dim, base)), rtol=1e-6)
    truth = _rope_f64(x, pos, base)
    bound = 2 * np.abs(x).max() * s * ROPE_ANGLE_ERR
    got = common.apply_rope(torch.from_numpy(x),
                            torch.from_numpy(pos.copy()), base).numpy()
    # the model's call: one row of positions for every row of x
    got_1 = common.apply_rope(torch.from_numpy(x), torch.arange(s)[None],
                              base).numpy()
    for name, out in (("reference", want), ("port", got),
                      ("port, one row of positions", got_1)):
        np.testing.assert_allclose(out, truth, rtol=0, atol=bound,
                                   err_msg=name)
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * bound)
    # a wrong base, layout or position is off by O(1), far beyond it
    assert bound < 1e-2 * np.abs(truth).max()
    # bf16 in, bf16 out
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert common.apply_rope(xb, torch.arange(s)[None], base).dtype \
        == torch.bfloat16


@pytest.mark.parametrize("window", [None, 64, 16, 1])
@pytest.mark.parametrize("heads", [(4, 4), (4, 1), (8, 2)])
def test_attention_matches_reference(window, heads):
    """Causal GQA attention, with and without a sliding window, against
    the reference's chunked online softmax (one chunk at S = 96)."""
    hq, kvh = heads
    r = _rng(4)
    q, k, v = (r.standard_normal((2, SEQ, h, 32)).astype(np.float32)
               for h in (hq, kvh, kvh))
    want = np.asarray(jcommon.attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), window=window))
    got = common.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if window == 1:     # each query sees itself only: out = v
        np.testing.assert_allclose(
            got.numpy(), np.repeat(v, hq // kvh, axis=2), atol=1e-6)


# ------------------------------------------------------- loss and gradients

@pytest.mark.parametrize("arch", DENSE)
def test_model_loss_and_grads_match_reference(arch):
    """Loss and every gradient leaf of the reduced model from the
    reference's parameters and batch (f32; summation order and the last
    bits of RoPE's angles only: rtol 1e-5 on the loss, 1e-4 of each
    leaf's gradient scale)."""
    jcfg = jget_config(arch).reduced()
    jmodel, jparams = _jinit(arch)
    # constant vectors (the norms' ones, the biases' zeros) would hide a
    # bias that is never added: give them random values
    rng = _rng(5)
    jparams = jax.tree.map(
        lambda v: v + jnp.asarray(0.1 * rng.standard_normal(v.shape),
                                  v.dtype)
        if np.ptp(np.asarray(v)) == 0 else v, jparams)
    data = JSyntheticLM(jcfg, JShapeSpec("t", "train", SEQ, BATCH),
                        n_workers=2, seed=0)
    jb = jax.tree.map(lambda v: v[0], data.batch_at(0))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb, remat=False)))(jparams)
    model = build_model(get_config(arch).reduced())
    tr = Trainer(model, TrainerConfig(), device="cpu")
    loss, grads = tr._grad_and_loss(
        params_from_jax(_np_tree(jparams)),
        {k: torch.from_numpy(np.array(v)).to(torch.int64)
         for k, v in jb.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tree_leaves(grads))
    for path, jg in jflat:
        g = grads
        for k in path:
            g = g[k.key]
        jg = np.asarray(jg)
        assert np.max(np.abs(jg)) > 0, path
        err = np.max(np.abs(g.numpy() - jg)) / np.max(np.abs(jg))
        assert err < 1e-4, (path, err)


# ------------------------------------------------ the optimizer's layout

def _budget_fields(b):
    return (b.pack_w2s, b.pack_s2w, b.n_stages, b.w2s_sizes, b.s2w_sizes,
            b.n_workers, b.two_way_nbytes)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("size", ["reduced", "depth8"])
def test_layer_plan_buckets_and_wire_equal_reference(arch, size):
    """On the new trees (meta tensors): the NS buckets (shapes, members,
    transposes, counts, radius scales), both directions' wire layouts
    and stage layouts, the s2w issue order and the wire budget, with
    ``--w2s top10+natural --s2w natural`` and 2 workers, equal the
    reference's."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    cfg, jcfg = ((cfg.reduced(), jcfg.reduced()) if size == "reduced"
                 else (cfg.with_depth(8), jcfg.with_depth(8)))
    shapes, metas = abstract_params(build_model(cfg))
    jshapes, jmetas = jabstract_params(jbuild_model(jcfg))
    kw = dict(n_workers=2, w2s="top10+natural", s2w="natural")
    opt, jopt = EF21Muon(EF21MuonConfig(**kw)), JEF21Muon(
        JEF21MuonConfig(**kw))
    plan, jplan = opt.plan(shapes, metas), jopt.plan(jshapes, jmetas)
    fields = ("shape", "leaf_ids", "leaf_shapes", "transposes", "counts",
              "radius_scales")
    assert [[getattr(b, f) for f in fields] for b in plan.ns_buckets()] \
        == [[getattr(b, f) for f in fields] for b in jplan.ns_buckets()]
    for direction in ("w2s", "s2w"):
        assert plan.wire_layout(torch.bfloat16, direction).describe() == \
            jplan.wire_layout(jnp.bfloat16, direction=direction).describe()
        sw = plan.staged_wire_layout(torch.bfloat16, plan.stage_plan(),
                                     direction)
        jsw = jplan.staged_wire_layout(jnp.bfloat16, jplan.stage_plan(),
                                       direction=direction)
        assert [s.describe() for s in sw.stages] == \
            [s.describe() for s in jsw.stages]
    assert s2w_issue_order(plan, plan.stage_plan()) == \
        js2w_issue_order(jplan, jplan.stage_plan())
    for distributed in (True, False):
        assert _budget_fields(opt.wire_budget(
            shapes, metas, distributed=distributed)) == _budget_fields(
            jopt.wire_budget(jshapes, jmetas, distributed=distributed))


@pytest.mark.parametrize("w2s,s2w,w2s_sizes,s2w_sizes", [
    ("top10", "identity",
     (186_920_142, 324_639_216, 33_554_480, 4_194_320), ()),
    ("top10+natural", "natural",
     (159_693_211, 277_296_000, 27_682_448, 3_460_320),
     (350_281_728, 608_698_368, 75_497_472, 9_437_184))])
def test_qwen_depth8_layout_pinned(w2s, s2w, w2s_sizes, s2w_sizes):
    """qwen2.5-3b at full width, 8 layers, 2 workers (the smoke's run):
    three NS buckets, [16, 256, 2048] (wk, wv, transposed), [16, 2048,
    2048] (wq, wo) and [24, 2048, 11008] (w_down transposed, w_gate,
    w_up), each one ``ns_iteration`` chunk; the sign LMO for embed, the
    biases and the norms; four wire stages of the bytes pinned here (the
    smoke's ``WIRE`` table holds the same, and the smoke checks its
    gathers and broadcasts against it), the s2w stages issued in the
    order (1, 0, 2, 3); the attention leaves' TopK indices in three
    bytes, embed's and the MLP's in four."""
    from repro_torch.kernels.ops import ns_batch_chunk
    cfg = get_config("qwen2.5-3b").with_depth(8)
    shapes, metas = abstract_params(build_model(cfg))
    opt = EF21Muon(EF21MuonConfig(n_workers=2, w2s=w2s, s2w=s2w))
    plan = opt.plan(shapes, metas)
    buckets = plan.ns_buckets()
    assert [(sum(b.counts),) + b.shape for b in buckets] == \
        [(16, 256, 2048), (16, 2048, 2048), (24, 2048, 11008)]
    assert [ns_batch_chunk(sum(b.counts), b.shape[0]) for b in buckets] \
        == [16, 16, 24]
    names = ["/".join(p) for p in leaf_paths(shapes)]
    spectral = {names[i] for b in buckets for i in b.leaf_ids}
    assert spectral == {f"dense_blocks/{k}" for k in (
        "attn/wk", "attn/wv", "attn/wq", "attn/wo", "mlp/w_down",
        "mlp/w_gate", "mlp/w_up")}
    assert all(lp.meta.lmo == "sign" for n, lp in zip(names, plan.leaves)
               if n not in spectral)
    b = opt.wire_budget(shapes, metas)
    assert (b.n_stages, b.w2s_sizes, b.s2w_sizes) == (4, w2s_sizes,
                                                      s2w_sizes)
    if s2w != "identity":
        assert s2w_issue_order(plan, plan.stage_plan()) == (1, 0, 2, 3)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    pins = smoke.WIRE["qwen2.5-3b", 8]
    assert pins["w2s"][w2s] == w2s_sizes
    assert pins["s2w"].get(s2w, ()) == s2w_sizes
    assert pins["order"] == (1, 0, 2, 3)
    widths = {names[i]: c.width for i, spec in enumerate(
        plan.wire_layout(torch.bfloat16).specs) for c in spec.codecs
        if isinstance(c, NarrowIntCodec)}
    assert widths == {f"dense_blocks/attn/{k}": 3
                      for k in ("wk", "wq", "wo", "wv")}


# --------------------------------------------------------------------- CLI

@pytest.mark.parametrize("arch", DENSE)
def test_cli_header_equals_reference(arch, capsys, monkeypatch):
    """Field for field, ``device=`` aside, one-way and two-way."""
    argv = ["--arch", arch, "--reduced", "--steps", "0", "--seq", "16",
            "--batch", "2", "--workers", "2", "--w2s", "top10+natural",
            "--s2w", "natural"]
    train_cli.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()[0].split()
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain_cli.main()
    theirs = capsys.readouterr().out.splitlines()[0].split()
    assert ours[-1] == "device=cpu"
    assert ours[:-1] == theirs
    assert ours[0] == f"arch={arch}"


def test_cli_header_of_reduced_qwen_pinned(capsys):
    train_cli.main(["--arch", "qwen2.5-3b", "--reduced", "--steps", "0",
                    "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[0] == (
        "arch=qwen2.5-3b params=1313024 w2s_bytes/worker=791088 (0.301 of "
        "dense) wire_buffer=625292 (0.238 of dense) s2w_bytes/round=0 "
        "s2w_wire_buffer=0 two_way_wire=625292 wire_stages=4 device=cpu")
