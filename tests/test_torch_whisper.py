"""Whisper in the port against the reference's.

``whisper-small`` is an encoder-decoder: a bidirectional encoder over
stub frame embeddings with sinusoid positions, a decoder of causal
self-attention, cross-attention to the encoder output and a GELU MLP,
learned positions, LayerNorm; its serving cache holds each layer's cross
K/V beside the self-attention's. On its ``reduced()`` config (2 + 2
layers, d_model 256, 4 heads, 64 frames, f32), from the reference's
parameters and batches carried across through numpy:

  * the configs field for field (published, reduced, ``with_depth``);
  * ``sinusoids``; bidirectional ``attention`` with fewer queries than
    keys (the reference walks 1500 keys in two chunks of 1024);
  * the parameter tree and metas, the parameter count, the NS buckets
    and wire at full width against the reference's and the smoke's pins;
  * the loss and every gradient leaf (``pos_embed``'s rows past the
    sequence exactly zero on both sides);
  * prefill logits and cache (self and cross K/V), 4 decode steps from
    the port's cache and from the reference's, decode against the full
    forward, ``Server.generate``'s greedy tokens;
  * ``input_specs`` / ``make_batch``, ``cache_spec`` and ``SyntheticLM``
    (keys, shapes, dtypes, a group's rows); the train and serve CLIs'
    lines;
  * one two-way EF21-Muon step from the reference's carried state.

Tolerances, f32 in another summation order: attention, logits and the
caches within ``ATOL`` (2e-5, ``test_torch_serve.py``'s; the port sums
each query's 1500 scores in one pass, the reference in two chunks with an
online softmax, so the two agree within f32 rounding, not bit for bit),
the loss within rtol 1e-5 and each gradient leaf within 1e-4 of its scale
(the dense family's).
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
from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import serve as jserve_cli
from repro.launch import train as jtrain_cli
from repro.models import common as jcommon
from repro.models import whisper as jwhisper
from repro.models.api import abstract_params as jabstract_params
from repro.models.api import build_model as jbuild_model
from repro.models.api import input_specs as jinput_specs
from repro.models.api import make_batch as jmake_batch
from repro.train.serve import Server as JServer
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.muon import EF21Muon, EF21MuonConfig
from repro_torch.core.schedule import warmup_linear_decay
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.dist import sharding
from repro_torch.dist.layerwise import (leaf_paths, tree_get, tree_leaves,
                                        tree_unflatten)
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import common
from repro_torch.models.api import (abstract_params, build_model,
                                    cache_from_jax, input_specs, make_batch,
                                    params_from_jax, state_from_jax)
from repro_torch.train.serve import Server
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_threads import one_torch_thread  # noqa: F401

ARCH = "whisper-small"
ATOL = 2e-5
X_ATOL = 1e-6         # x after NS-driven LMO steps (test_torch_s2w.py)
SEQ, BATCH, WORKERS = 24, 4, 2
OPT = dict(n_workers=WORKERS, beta=0.5, w2s="top10", s2w="natural")
_t = warmup_linear_decay(0.01, 3, 10)
B, PROMPT, N_DECODE = 2, 6, 4
CACHE_KEYS = ["k", "v", "xk", "xv"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rng(seed):
    return np.random.default_rng(seed)


def _cfgs(variant: str):
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    if variant == "reduced":
        return cfg.reduced(), jcfg.reduced()
    if variant.startswith("depth"):
        k = int(variant[5:])
        return cfg.with_depth(k), jcfg.with_depth(k)
    return cfg, jcfg


def _to_torch(batch: dict) -> dict:
    """A reference batch as the port's: ints as int64, floats as they
    are."""
    out = {}
    for k, v in batch.items():
        a = torch.from_numpy(np.array(v))
        out[k] = a if a.is_floating_point() else a.to(torch.int64)
    return out


def _to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v.numpy(), None if v.is_floating_point()
                           else jnp.int32) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's reduced model, params, metas, 2 synthetic batches
    of 2 workers and its compiled loss-and-gradient."""
    _, jcfg = _cfgs("reduced")
    jmodel = jbuild_model(jcfg)
    _, jmetas = jabstract_params(jmodel)
    jparams = jax.jit(lambda k: jmodel.init(k)[0])(jax.random.key(0))
    data = JSyntheticLM(jcfg, JShapeSpec("t", "train", SEQ, BATCH),
                        n_workers=WORKERS, seed=0)
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b, remat=False)))
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, jmetas=jmetas,
                batches=[data.batch_at(s) for s in range(2)], jgrad=jgrad)


def _port():
    return (build_model(_cfgs("reduced")[0]),
            params_from_jax(_np_tree(_reference()["jparams"])))


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("variant", ["full", "reduced", "depth4"])
def test_config_matches_reference(variant):
    cfg, jcfg = _cfgs(variant)
    for f in dataclasses.fields(cfg):
        a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name == "encoder":
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    assert cfg.hd == jcfg.hd
    assert (cfg.family, cfg.frontend, cfg.rope) == ("audio", "audio",
                                                   "learned")
    assert (cfg.encoder.n_layers, cfg.encoder.n_frames) == (
        (2, 64) if variant == "reduced" else (12, 1500))


# --------------------------------------------------------------- primitives

@pytest.mark.parametrize("length, channels", [(64, 256), (1500, 768)])
def test_sinusoids_match_reference(length, channels):
    """f32 throughout, as the reference's: within a few f32 roundings of
    the angle (|t| up to ``length``) of it and of float64."""
    got = common.sinusoids(length, channels).numpy()
    want = np.asarray(jwhisper.sinusoids(length, channels))
    assert got.dtype == np.float32 and got.shape == (length, channels)
    inv = np.exp(-np.log(10000.0) / (channels // 2 - 1)
                 * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    truth = np.concatenate([np.sin(t), np.cos(t)], 1)
    bound = 8 * length * 2 ** -24
    np.testing.assert_allclose(got, truth, rtol=0, atol=bound)
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


@pytest.mark.parametrize("n_kv", [64, 1500])
def test_bidirectional_attention_with_fewer_queries_than_keys(n_kv):
    """``attention(causal=False)`` of 40 queries against ``n_kv`` keys
    (Whisper's cross-attention; at 1500 the reference's two key chunks,
    the second padded and masked) within f32 rounding of the
    reference's; with as many queries as keys (the encoder) too; a
    window is refused."""
    g = _rng(0)
    q = g.standard_normal((2, 40, 4, 32)).astype(np.float32)
    k, v = (g.standard_normal((2, n_kv, 4, 32)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jcommon.attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=False))
    got = common.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    kq = k[:, :40]
    want = np.asarray(jcommon.attention(jnp.asarray(q), jnp.asarray(kq),
                                        jnp.asarray(v[:, :40]), causal=False))
    got = common.attention(torch.from_numpy(q), torch.from_numpy(kq),
                           torch.from_numpy(v[:, :40]), causal=False,
                           chunk=16).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    causal = common.attention(torch.from_numpy(q), torch.from_numpy(kq),
                              torch.from_numpy(v[:, :40])).numpy()
    assert np.abs(causal - got).max() > 100 * ATOL
    with pytest.raises(ValueError, match="causal"):
        common.attention(torch.from_numpy(q), torch.from_numpy(kq),
                         torch.from_numpy(v[:, :40]), window=8, causal=False)


# ------------------------------------------------------- params and metas

@pytest.mark.parametrize("size, n_params", [("reduced", 3_020_800),
                                            ("full", 303_106_560)])
def test_param_tree_and_metas_match_reference(size, n_params):
    """Leaf paths in flatten order, shapes, dtypes, every meta (the
    unembedding's sign LMO, the encoder's and decoder's stacks) and the
    parameter count, reduced and at the published widths (meta
    tensors); ``pos_embed`` is the reference's ``max_position`` rows."""
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
    assert sorted(params) == ["dec_blocks", "embed", "enc_blocks",
                              "enc_final_ln_b", "enc_final_ln_w",
                              "final_ln_b", "final_ln_w", "pos_embed",
                              "unembed"]
    assert sorted(params["dec_blocks"]["xattn"]) == ["wk", "wo", "wq", "wv"]
    assert tuple(params["pos_embed"].shape) == (cfg.max_position,
                                                cfg.d_model)
    assert metas["unembed"].lmo == "sign"
    assert sum(p.numel() for p in tree_leaves(params)) == n_params


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _budget_fields(b):
    return (b.pack_w2s, b.pack_s2w, b.n_stages, b.w2s_sizes, b.s2w_sizes,
            b.n_workers, b.two_way_nbytes)


def test_full_plan_equals_reference_and_smoke():
    """At full size, 2 workers (the smoke's run): the NS buckets, both
    wire layouts and the budgets of top10, top10 / natural and
    top10+natural / natural equal the reference's and the smoke's
    pins."""
    shapes, metas = abstract_params(build_model(_cfgs("full")[0]))
    jshapes, jmetas = jabstract_params(jbuild_model(_cfgs("full")[1]))
    smoke = _smoke()
    pins = smoke.WIRE[ARCH, 12]
    for w2s, s2w in (("top10", "identity"), ("top10", "natural"),
                     ("top10+natural", "natural")):
        kw = dict(n_workers=2, w2s=w2s, s2w=s2w)
        opt, jopt = EF21Muon(EF21MuonConfig(**kw)), JEF21Muon(
            JEF21MuonConfig(**kw))
        plan, jplan = opt.plan(shapes, metas), jopt.plan(jshapes, jmetas)
        got = [(sum(b.counts),) + b.shape for b in plan.ns_buckets()]
        assert got == [(sum(b.counts),) + b.shape
                       for b in jplan.ns_buckets()]
        assert sorted(got) == sorted(smoke.WHISPER_BUCKETS)
        for direction in ("w2s", "s2w"):
            assert plan.wire_layout(torch.bfloat16, direction).describe() \
                == jplan.wire_layout(jnp.bfloat16,
                                     direction=direction).describe()
        b = opt.wire_budget(shapes, metas)
        assert _budget_fields(b) == _budget_fields(
            jopt.wire_budget(jshapes, jmetas))
        assert b.w2s_sizes == pins["w2s"][w2s]
        assert b.s2w_sizes == pins["s2w"].get(s2w, ())


# ------------------------------------------------------- loss and gradients

def test_model_loss_and_grads_match_reference():
    """The loss and every gradient leaf on a frames + tokens batch; the
    rows of ``pos_embed`` past the sequence get exact zeros."""
    ref = _reference()
    jb = jax.tree.map(lambda v: v[0], ref["batches"][0])
    assert set(jb) == {"frames", "tokens", "labels"}
    jloss, jgrads = ref["jgrad"](ref["jparams"], jb)
    model, params = _port()
    tr = Trainer(model, TrainerConfig(), device="cpu")
    loss, grads = tr._grad_and_loss(params, _to_torch(jb))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tree_leaves(grads))
    for path, jg in jflat:
        key = tuple(k.key for k in path)
        g, jg = tree_get(grads, key), np.asarray(jg)
        assert np.max(np.abs(jg)) > 0, key
        err = np.max(np.abs(g.numpy() - jg)) / np.max(np.abs(jg))
        assert err < 1e-4, (key, err)
    pe = grads["pos_embed"]
    assert not torch.any(pe[SEQ:]) and bool(torch.all(
        pe[:SEQ].abs().sum(-1) > 0))


# ------------------------------------------------------ the carried step

@functools.lru_cache(maxsize=None)
def _reference_states():
    """The reference's two-way states after steps 0 and 1 of reduced
    whisper from init, each step on the reference model's gradients at
    the W it reaches (``test_torch_dense_steps.py``'s ``_ref_step``)."""
    ref = _reference()
    jgrad = ref["jgrad"]
    jopt = JEF21Muon(JEF21MuonConfig(use_pallas=False, **OPT))
    fn = jopt.make_step(ref["jmetas"], reshard_payloads=lambda t: t,
                        reshard_updates=lambda t: t)
    jstep = jax.jit(lambda s, b, t: fn(s, lambda p, b: (b["loss"],
                                                        b["grads"]), b, t))
    state = jopt.init(jax.random.key(1), ref["jparams"], ref["jmetas"])
    states = [state]
    for s in range(2):
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
    """From the reference's state after step 0 (X != W), one packed
    two-way ``top10`` / ``natural`` step (the smoke's run), both sides
    fed the reference model's gradients at the W each reaches: w, g_w,
    m_w and g_server bit-equal, x within X_ATOL, every leaf moved (the
    encoder's and the cross-attention's among them)."""
    ref = _reference()
    states = _reference_states()
    jstate, want = _np_tree(states[1]), _np_tree(states[2])
    paths = leaf_paths(jstate["x"])

    def grad_and_loss(params, batch):
        jp = tree_unflatten(paths, [jnp.asarray(tree_get(params, p).numpy())
                                    for p in paths])
        loss, grads = ref["jgrad"](jp, _to_jax(batch))
        return torch.tensor(float(loss)), params_from_jax(_np_tree(grads))

    _, metas = build_model(_cfgs("reduced")[0]).init(None, "meta")
    step = EF21Muon(EF21MuonConfig(**OPT)).make_step(
        metas, reshard_payloads=lambda t: t, reshard_updates=lambda t: t)
    tstate, _ = step(state_from_jax(jstate), grad_and_loss,
                     _to_torch(ref["batches"][1]), _t(1))
    assert tstate["step"] == int(want["step"]) == 2
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


# ------------------------------------------------------------------ serving

@functools.lru_cache(maxsize=None)
def _serving_reference():
    """The reference's prefill of a frames + tokens prompt into a cache
    of PROMPT + N_DECODE, then N_DECODE teacher-forced decode steps:
    logits and caches."""
    ref = _reference()
    jm, jp = ref["jmodel"], ref["jparams"]
    prompt = jmake_batch(ref["jcfg"], JShapeSpec("p", "prefill", PROMPT, B),
                         jax.random.key(7))
    toks = _rng(1).integers(0, 512, (B, N_DECODE)).astype(np.int32)
    logits, cache = jax.jit(jm.prefill)(jp, prompt,
                                        jm.init_cache(B, PROMPT + N_DECODE))
    out = {"prompt": _np_tree(prompt), "tokens": toks,
           "prefill": (np.asarray(logits), _np_tree(cache)), "decode": []}
    dec = jax.jit(jm.decode_step)
    for i in range(N_DECODE):
        logits, cache = dec(jp, {"token": jnp.asarray(toks[:, i:i + 1]),
                                 "t": jnp.asarray(PROMPT + i, jnp.int32)},
                            cache)
        out["decode"].append((np.asarray(logits), _np_tree(cache)))
    return out


def _caches_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want) == CACHE_KEYS
    for kv in CACHE_KEYS:
        assert tuple(got[kv].shape) == want[kv].shape, kv
        np.testing.assert_allclose(got[kv].numpy(), want[kv], rtol=0,
                                   atol=ATOL, err_msg=kv)


@pytest.mark.parametrize("source", ["port", "reference"])
def test_prefill_and_decode_match_reference(source):
    """Prefill's logits and cache (the self-attention's k, v padded to
    the cache's length, the cross K/V of the 64 frames), then 4 decode
    steps from the port's cache or the reference's."""
    sref = _serving_reference()
    model, params = _port()
    prompt = _to_torch(sref["prompt"])
    assert set(prompt) == {"frames", "tokens"}
    cache = model.init_cache(B, PROMPT + N_DECODE, "cpu")
    logits, cache = model.prefill(params, prompt, cache)
    np.testing.assert_allclose(logits.numpy(), sref["prefill"][0], rtol=0,
                               atol=ATOL)
    _caches_close(cache, sref["prefill"][1])
    if source == "reference":
        cache = cache_from_jax(sref["prefill"][1])
    for i, (want_logits, want_cache) in enumerate(sref["decode"]):
        logits, cache = model.decode_step(params, {
            "token": torch.from_numpy(sref["tokens"][:, i:i + 1]),
            "t": torch.tensor(PROMPT + i, dtype=torch.int32)}, cache)
        np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                                   atol=ATOL, err_msg=f"step {i}")
    _caches_close(cache, want_cache)


def test_decode_matches_the_full_forward():
    """Decode after the prompt against the port's own forward over the
    prompt's tokens and the decoded ones, on the same frames."""
    sref = _serving_reference()
    model, params = _port()
    prompt = _to_torch(sref["prompt"])
    toks = torch.from_numpy(sref["tokens"]).to(torch.int64)
    _, cache = model.prefill(params, prompt,
                             model.init_cache(B, PROMPT + N_DECODE, "cpu"))
    dec = []
    for i in range(N_DECODE):
        lg, cache = model.decode_step(params, {"token": toks[:, i:i + 1],
                                               "t": PROMPT + i}, cache)
        dec.append(lg)
    with torch.inference_mode():
        h = model.hidden(params, {"frames": prompt["frames"], "tokens":
                                  torch.cat([prompt["tokens"], toks], 1)})
    for i in range(N_DECODE):
        want = common.logits_last(h[:, PROMPT + i], params["unembed"])
        np.testing.assert_allclose(dec[i].numpy(), want.numpy(), rtol=0,
                                   atol=ATOL, err_msg=f"step {i}")


def test_generate_greedy_equals_reference():
    """Greedy tokens after a frames + tokens prompt equal the reference
    Server's."""
    ref, sref = _reference(), _serving_reference()
    model, params = _port()
    jtoks = np.asarray(JServer(ref["jmodel"]).generate(
        ref["jparams"], jax.tree.map(jnp.asarray, sref["prompt"]), 5))
    toks = Server(model).generate(params, _to_torch(sref["prompt"]), 5)
    assert toks.dtype == torch.int32 and toks.shape == (B, 5)
    np.testing.assert_array_equal(toks.numpy(), jtoks)


# -------------------------------------------------------------- batches

def test_input_specs_make_batch_and_cache_spec_match_reference():
    """Every shape kind's keys, shapes and dtypes equal the reference's
    (reduced and full); ``make_batch``'s frames are N(0, 0.02^2) in the
    model's dtype; the cache's four leaves (``cache_spec``, meta) equal
    the reference's at full size."""
    g = torch.Generator().manual_seed(0)
    for size in ("reduced", "full"):
        cfg, jcfg = _cfgs(size)
        for kind in ("train", "prefill", "decode"):
            shape = ShapeSpec("s", kind, 48, 8)
            specs = input_specs(cfg, shape, n_workers=2)
            jspecs = jinput_specs(jcfg, JShapeSpec("s", kind, 48, 8),
                                  n_workers=2)
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
                    for k, v in specs.items()} == \
                {k: (v.shape, str(v.dtype)) for k, v in jspecs.items()}
            assert list(specs) == list(jspecs)
    cfg = _cfgs("reduced")[0]
    b = make_batch(cfg, ShapeSpec("s", "train", 48, 16), g, device="cpu")
    assert list(b) == ["frames", "tokens", "labels"]
    assert b["frames"].dtype == torch.float32
    assert tuple(b["frames"].shape) == (1, 16, 64, 256)
    assert abs(b["frames"].std().item() - 0.02) < 1e-3
    assert int(b["tokens"].max()) < cfg.vocab
    cfg, jcfg = _cfgs("full")
    cs = build_model(cfg).cache_spec(8, 512)
    jcs = jbuild_model(jcfg).cache_spec(8, 512)
    assert sorted(cs) == sorted(jcs) == CACHE_KEYS
    for k in CACHE_KEYS:
        assert cs[k].device.type == "meta"
        assert (tuple(cs[k].shape), str(cs[k].dtype).split(".")[1]) == \
            (jcs[k].shape, str(jcs[k].dtype))
    assert tuple(cs["xk"].shape) == (12, 8, 1500, 12, 64)


def test_synthetic_batches_and_group_rows(monkeypatch):
    """``SyntheticLM``'s audio batch: frames beside tokens and labels,
    the reference's keys and shapes; prefill without labels; on a group,
    a rank's rows of every key are the one-process batch's."""
    cfg, jcfg = _cfgs("reduced")
    shape = ShapeSpec("t", "train", SEQ, BATCH)
    data = SyntheticLM(cfg, shape, n_workers=WORKERS, device="cpu")
    b = data.batch_at(3)
    jb = JSyntheticLM(jcfg, JShapeSpec("t", "train", SEQ, BATCH),
                      n_workers=WORKERS).batch_at(3)
    assert list(b) == list(jb) == ["tokens", "labels", "frames"]
    for k in b:
        assert tuple(b[k].shape) == jb[k].shape, k
    assert b["frames"].dtype == torch.float32
    assert torch.equal(b["frames"], data.batch_at(3)["frames"])
    pre = SyntheticLM(cfg, ShapeSpec("p", "prefill", SEQ, 3),
                      device="cpu").batch_at(0)
    assert list(pre) == ["tokens", "frames"] and \
        tuple(pre["frames"].shape) == (3, 64, 256)
    monkeypatch.setattr(sharding, "local_workers", lambda g, n: range(1, 2))
    rank = SyntheticLM(cfg, shape, n_workers=WORKERS, device="cpu",
                       group=object()).batch_at(3)
    assert list(rank) == list(b)
    for k in b:
        assert torch.equal(rank[k], b[k][1:2]), k


# ---------------------------------------------------------------------- CLI

def test_cli_headers_equal_reference(capsys, monkeypatch):
    """The train CLI's header field for field (``device=`` aside), one
    way and two-way (the smoke's top10 / natural), and the serve CLI's
    line (a frames + tokens prompt) but for the wall time and rate."""
    for w2s, s2w in (("top10", "identity"), ("top10", "natural")):
        argv = ["--arch", ARCH, "--reduced", "--steps", "0", "--seq", "16",
                "--batch", "2", "--workers", "2", "--w2s", w2s, "--s2w", s2w]
        train_cli.main(argv + ["--device", "cpu"])
        ours = capsys.readouterr().out.splitlines()[0].split()
        monkeypatch.setattr(sys, "argv", ["train"] + argv)
        jtrain_cli.main()
        theirs = capsys.readouterr().out.splitlines()[0].split()
        assert ours[-1] == "device=cpu" and ours[:-1] == theirs
        assert ours[0] == f"arch={ARCH}"
    sargv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
             "4", "--max-new", "4"]
    out = serve_cli.main(sargv + ["--device", "cpu"])
    line = capsys.readouterr().out.splitlines()[1].split()
    monkeypatch.setattr(sys, "argv", ["serve"] + sargv)
    jserve_cli.main()
    jline = capsys.readouterr().out.splitlines()[0].split()
    assert line[-1] == "device=cpu"
    assert [w for w in line if not w.startswith(("wall=", "("))][:-1] == \
        [w for w in jline if not w.startswith(("wall=", "("))]
    assert tuple(out["tokens"].shape) == (2, 4)
