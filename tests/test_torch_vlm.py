"""Qwen2-VL in the port against the reference's.

``qwen2-vl-7b`` is the dense transformer with QKV bias and M-RoPE (three
position channels, temporal / height / width, each turning its own
section of the rotary frequencies) over a prompt of precomputed patch
embeddings: its batches are ``{"embeds", "pos", "labels"}``, no tokens
(the vision tower is the reference's stub). On its ``reduced()`` config
(2 layers, d_model 256, 4 heads of 64, sections (8, 12, 12), f32), from
the reference's parameters and batches carried across through numpy:

  * the configs field for field (published, reduced, ``with_depth``);
  * ``apply_rope`` with sections against the reference's and float64;
  * the parameter tree and metas, the parameter counts the smoke trains
    and serves, the NS buckets and wire of the smoke's training cut;
  * the loss and every gradient leaf (``embed`` exactly zero: the loss
    never reads it), on the synthetic batch and on ``make_batch``'s
    random M-RoPE ids; the trainer's gradient pass zero-fills exactly the
    leaves the model names unreached and raises for any other;
  * prefill logits and cache after an ``embeds`` prompt, 4 decode steps
    from the port's cache and from the reference's, decode against the
    full forward, ``Server.generate``'s greedy tokens;
  * ``input_specs`` / ``make_batch`` and ``SyntheticLM`` (keys, shapes,
    dtypes, a group's rows); the train and serve CLIs' lines;
  * TopK of ``embed``'s all-zero slice (lowest indices first, as
    ``lax.top_k``), and one two-way EF21-Muon step from the reference's
    carried state.

Tolerances, f32 in another summation order: logits and the cache within
``ATOL`` (2e-5, ``test_torch_serve.py``'s), the loss within rtol 1e-5
and each gradient leaf within 1e-4 of its scale (the dense family's).
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
from repro.core import compressors as jcomp
from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import serve as jserve_cli
from repro.launch import train as jtrain_cli
from repro.models import common as jcommon
from repro.models.api import abstract_params as jabstract_params
from repro.models.api import build_model as jbuild_model
from repro.models.api import input_specs as jinput_specs
from repro.models.api import make_batch as jmake_batch
from repro.train.serve import Server as JServer
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import compressors as comp
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
from repro_torch.wire.codecs import NarrowIntCodec
from test_torch_threads import one_torch_thread  # noqa: F401

ARCH = "qwen2-vl-7b"
ATOL = 2e-5
X_ATOL = 1e-6         # x after NS-driven LMO steps (test_torch_s2w.py)
SEQ, BATCH, WORKERS = 32, 4, 2
OPT = dict(n_workers=WORKERS, beta=0.5, w2s="top10+natural", s2w="natural")
_t = warmup_linear_decay(0.01, 3, 10)
B, PROMPT, N_DECODE = 2, 12, 4
ROPE_ANGLE_ERR = 5 * 2 ** -24       # test_torch_dense_zoo.py's


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
    of 2 workers, a ``make_batch`` batch (random M-RoPE ids) and its
    compiled loss-and-gradient."""
    _, jcfg = _cfgs("reduced")
    jmodel = jbuild_model(jcfg)
    _, jmetas = jabstract_params(jmodel)
    jparams = jax.jit(lambda k: jmodel.init(k)[0])(jax.random.key(0))
    data = JSyntheticLM(jcfg, JShapeSpec("t", "train", SEQ, BATCH),
                        n_workers=WORKERS, seed=0)
    random_pos = jmake_batch(jcfg, JShapeSpec("t", "train", SEQ, BATCH),
                             jax.random.key(5), n_workers=WORKERS)
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b, remat=False)))
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, jmetas=jmetas,
                batches=[data.batch_at(s) for s in range(2)],
                random_pos=random_pos, jgrad=jgrad)


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("variant", ["full", "reduced", "depth2", "depth4"])
def test_config_matches_reference(variant):
    cfg, jcfg = _cfgs(variant)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.hd == jcfg.hd
    assert cfg.family == "vlm" and cfg.rope == "mrope"
    assert cfg.mrope_sections == ((8, 12, 12) if variant == "reduced"
                                  else (16, 24, 24))
    assert sum(cfg.mrope_sections) == cfg.hd // 2


# ------------------------------------------------------------------- M-RoPE

def _mrope_f64(x, pos, base, sections):
    d2 = x.shape[-1] // 2
    freqs = base ** (-np.arange(d2, dtype=np.float64) / d2)
    ch = np.repeat(np.arange(3), sections)
    angle = pos[..., ch].astype(np.float64) * freqs
    cos, sin = np.cos(angle)[:, :, None], np.sin(angle)[:, :, None]
    x1, x2 = x[..., :d2].astype(np.float64), x[..., d2:].astype(np.float64)
    return np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


@pytest.mark.parametrize("head_dim, sections", [(128, (16, 24, 24)),
                                                (64, (8, 12, 12))])
def test_mrope_matches_reference(head_dim, sections):
    """Sections over [B, S, 3] position ids up to 1024 at base 1e6 (the
    published config): both sides within the rounding of an f32 angle of
    the float64 rotation, and within twice that of each other; the
    three channels turn their own frequencies (a permuted channel is off
    by O(1)); bf16 in, bf16 out."""
    s, pmax = 64, 1024
    x = _rng(3).standard_normal((2, s, 3, head_dim)).astype(np.float32)
    pos = _rng(4).integers(0, pmax, (2, s, 3))
    want = np.asarray(jcommon.apply_rope(
        jnp.asarray(x), jnp.asarray(pos, jnp.int32), base=1e6,
        mrope_sections=sections))
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            1e6, sections).numpy()
    truth = _mrope_f64(x, pos, 1e6, sections)
    bound = 2 * np.abs(x).max() * pmax * ROPE_ANGLE_ERR
    np.testing.assert_allclose(want, truth, rtol=0, atol=bound)
    np.testing.assert_allclose(got, truth, rtol=0, atol=bound)
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * bound)
    swapped = _mrope_f64(x, pos[..., ::-1], 1e6, sections)
    assert np.abs(swapped - truth).max() > 100 * bound
    # one position on all three channels is plain RoPE
    same = np.repeat(pos[..., :1], 3, -1)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(same), 1e6,
                          sections).numpy(),
        common.apply_rope(torch.from_numpy(x),
                          torch.from_numpy(same[..., 0]), 1e6).numpy(),
        rtol=0, atol=0)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert common.apply_rope(xb, torch.from_numpy(pos), 1e6,
                             sections).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="sections"):
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                          (8, 8, 8))


# ------------------------------------------------------- params and metas

@pytest.mark.parametrize("size, n_params", [
    ("reduced", 1_575_680), ("full", 7_615_616_512),
    ("depth2", 1_556_113_920), ("depth4", 2_022_229_504)])
def test_param_tree_and_metas_match_reference(size, n_params):
    """Leaf paths in flatten order, shapes, dtypes, every meta (the
    untied ``unembed``'s sign LMO) and the parameter count, reduced and
    at the published widths (meta tensors)."""
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
    assert metas["unembed"].lmo == "sign" and "bq" in params[
        "dense_blocks"]["attn"]
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


def test_training_cut_plan_equals_reference_and_smoke():
    """``with_depth(2)``, 2 workers (the smoke's run): the NS buckets
    (the 3584-wide attention and the [., 3584, 18944] MLP) and the wire
    layouts and budgets of top10 and top10+natural / natural equal the
    reference's and the smoke's pins; embed's and unembed's 545 M-entry
    slices send raw int32 indices (past 2^24), the attention leaves'
    three bytes."""
    cfg, jcfg = _cfgs("depth2")
    shapes, metas = abstract_params(build_model(cfg))
    jshapes, jmetas = jabstract_params(jbuild_model(jcfg))
    smoke = _smoke()
    names = ["/".join(p) for p in leaf_paths(shapes)]
    for w2s, s2w in (("top10", "identity"), ("top10+natural", "natural")):
        kw = dict(n_workers=2, w2s=w2s, s2w=s2w)
        opt, jopt = EF21Muon(EF21MuonConfig(**kw)), JEF21Muon(
            JEF21MuonConfig(**kw))
        plan, jplan = opt.plan(shapes, metas), jopt.plan(jshapes, jmetas)
        got = [(sum(b.counts),) + b.shape for b in plan.ns_buckets()]
        assert got == [(sum(b.counts),) + b.shape
                       for b in jplan.ns_buckets()]
        assert sorted(got) == sorted(smoke.QWEN_VL_BUCKETS)
        for direction in ("w2s", "s2w"):
            assert plan.wire_layout(torch.bfloat16, direction).describe() \
                == jplan.wire_layout(jnp.bfloat16,
                                     direction=direction).describe()
        b = opt.wire_budget(shapes, metas)
        assert _budget_fields(b) == _budget_fields(
            jopt.wire_budget(jshapes, jmetas))
        pins = smoke.WIRE[ARCH, 2]
        assert b.w2s_sizes == pins["w2s"][w2s]
        assert b.s2w_sizes == pins["s2w"].get(s2w, ())
        widths = {names[i]: c.width for i, spec in enumerate(
            plan.wire_layout(torch.bfloat16).specs) for c in spec.codecs
            if isinstance(c, NarrowIntCodec)}
        assert widths == {f"dense_blocks/attn/{k}": 3
                          for k in ("wk", "wq", "wo", "wv")}


# ------------------------------------------------------- loss and gradients

@pytest.mark.parametrize("source", ["synthetic", "make_batch"])
def test_model_loss_and_grads_match_reference(source):
    """The loss and every gradient leaf on an ``embeds`` batch, with
    the synthetic ``arange`` M-RoPE ids or ``make_batch``'s random ones;
    ``embed`` gets an exactly-zero gradient on both sides."""
    ref = _reference()
    jb = ref["batches"][0] if source == "synthetic" else ref["random_pos"]
    jb = jax.tree.map(lambda v: v[0], jb)
    assert set(jb) == {"embeds", "pos", "labels"}
    jloss, jgrads = ref["jgrad"](ref["jparams"], jb)
    tr = Trainer(build_model(_cfgs("reduced")[0]), TrainerConfig(),
                 device="cpu")
    loss, grads = tr._grad_and_loss(params_from_jax(_np_tree(ref["jparams"])),
                                    _to_torch(jb))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tree_leaves(grads))
    for path, jg in jflat:
        key = tuple(k.key for k in path)
        g, jg = tree_get(grads, key), np.asarray(jg)
        if key == ("embed",):
            assert not np.any(jg) and not torch.any(g)
            assert g.dtype == torch.float32
            continue
        assert np.max(np.abs(jg)) > 0, key
        err = np.max(np.abs(g.numpy() - jg)) / np.max(np.abs(jg))
        assert err < 1e-4, (key, err)


class _Naming:
    """A model whose ``unreached_leaves`` names ``paths`` for every
    batch, all else the wrapped model's."""

    def __init__(self, model, paths):
        self.model, self.paths = model, frozenset(paths)

    def __getattr__(self, name):
        return getattr(self.model, name)

    def unreached_leaves(self, batch):
        return self.paths


@pytest.mark.parametrize("kind,named,error", [
    ("embeds", None, None),           # the model's own: embed only
    ("tokens", None, None),           # every leaf reached, none named
    # embed unreached but not named: autograd's strict default raises
    ("embeds", (), "not have been used in the graph"),
    ("tokens", (("embed",),), "without a gradient"),  # named but reached
])
def test_grad_pass_zero_fills_only_the_leaves_the_model_names(kind, named,
                                                              error):
    """The trainer's gradient pass gives zeros to exactly the leaves
    ``unreached_leaves`` names and raises where the loss leaves out any
    other leaf, or reaches a named one."""
    cfg = _cfgs("reduced")[0]
    model = build_model(cfg)
    params, _ = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    labels = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    if kind == "embeds":
        batch = {"embeds": 0.02 * torch.randn(2, 8, cfg.d_model,
                                              generator=gen),
                 "pos": torch.arange(8)[None, :, None].expand(2, 8, 3),
                 "labels": labels}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8),
                                         generator=gen), "labels": labels}
    tr = Trainer(model if named is None else _Naming(model, named),
                 TrainerConfig(), device="cpu")
    if error is not None:
        with pytest.raises(RuntimeError, match=error):
            tr._grad_and_loss(params, batch)
        return
    _, grads = tr._grad_and_loss(params, batch)
    for path in leaf_paths(grads):
        zero = not torch.any(tree_get(grads, path))
        assert zero == (kind == "embeds" and path == ("embed",)), path


def test_topk_of_an_all_zero_slice_picks_the_lowest_indices():
    """embed's EF21 target is exactly zero: TopK keeps k zeros at
    indices 0..k-1 of each worker's slice, as ``lax.top_k`` (the payload
    bit-equal to the reference's)."""
    x = np.zeros((WORKERS, 512, 256), np.float32)
    c, jc = comp.get_compressor("top10"), jcomp.get_compressor("top10")
    got, _ = c.compress({}, torch.from_numpy(x), (512, 256))
    want = jax.vmap(lambda a: jc.compress({}, a)[0])(jnp.asarray(x))
    k = c.k_for((512, 256))
    assert tuple(got["indices"].shape) == (WORKERS, k)
    np.testing.assert_array_equal(got["indices"].numpy(),
                                  np.asarray(want["indices"]))
    np.testing.assert_array_equal(got["indices"].numpy(),
                                  np.broadcast_to(np.arange(k), (WORKERS, k)))
    assert not torch.any(got["values"])


# ------------------------------------------------------ the carried step

@functools.lru_cache(maxsize=None)
def _reference_states():
    """The reference's two-way states after steps 0 and 1 of reduced
    qwen2-vl from init, each step on the reference model's gradients at
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
    two-way ``top10+natural`` / ``natural`` step, both sides fed the
    reference model's gradients at the W each reaches: w, g_w, m_w and
    g_server bit-equal, x within X_ATOL; ``embed``'s EF21 state stays
    zero (its gradient is), every other leaf moves."""
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
    assert not torch.any(tstate["g_w"]["embed"])
    for p in paths:
        got, w = tree_get(tstate["x"], p).numpy(), tree_get(want["x"], p)
        np.testing.assert_allclose(got, w, rtol=0, atol=X_ATOL,
                                   err_msg=f"x/{p}")
        if p != ("embed",):
            assert np.any(w != tree_get(jstate["x"], p)), p


# ------------------------------------------------------------------ serving

@functools.lru_cache(maxsize=None)
def _serving_reference():
    """The reference's prefill of an ``embeds`` prompt (random M-RoPE
    ids) into a cache of PROMPT + N_DECODE, then N_DECODE teacher-forced
    decode steps: logits and caches."""
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
    assert sorted(got) == sorted(want) == ["dense_blocks"]
    for kv in ("k", "v"):
        assert tuple(got["dense_blocks"][kv].shape) == \
            want["dense_blocks"][kv].shape
        np.testing.assert_allclose(got["dense_blocks"][kv].numpy(),
                                   want["dense_blocks"][kv], rtol=0,
                                   atol=ATOL, err_msg=kv)


@pytest.mark.parametrize("source", ["port", "reference"])
def test_prefill_and_decode_match_reference(source):
    """Prefill's logits and cache after an ``embeds`` prompt, then 4
    decode steps (the token through ``embed``, position t on all three
    channels) from the port's cache or the reference's."""
    sref = _serving_reference()
    model = build_model(_cfgs("reduced")[0])
    params = params_from_jax(_np_tree(_reference()["jparams"]))
    prompt = _to_torch(sref["prompt"])
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
    """Decode after an ``embeds`` prompt against the port's own forward
    over the prompt's embeddings followed by the decoded tokens'
    (``embed`` rows, their position on all three channels)."""
    sref = _serving_reference()
    model = build_model(_cfgs("reduced")[0])
    params = params_from_jax(_np_tree(_reference()["jparams"]))
    prompt = _to_torch(sref["prompt"])
    toks = torch.from_numpy(sref["tokens"])
    _, cache = model.prefill(params, prompt,
                             model.init_cache(B, PROMPT + N_DECODE, "cpu"))
    dec = []
    for i in range(N_DECODE):
        lg, cache = model.decode_step(params, {"token": toks[:, i:i + 1],
                                               "t": PROMPT + i}, cache)
        dec.append(lg)
    t = torch.arange(PROMPT, PROMPT + N_DECODE)
    full = {"embeds": torch.cat([prompt["embeds"], params["embed"][toks]], 1),
            "pos": torch.cat([prompt["pos"], t[None, :, None].expand(
                B, -1, 3)], 1)}
    with torch.inference_mode():
        x, pos = model._embed_in(params, full)
        h, _ = model._run(params, x, pos)
    for i in range(N_DECODE):
        want = common.logits_last(h[:, PROMPT + i], params["unembed"])
        np.testing.assert_allclose(dec[i].numpy(), want.numpy(), rtol=0,
                                   atol=ATOL, err_msg=f"step {i}")


def test_generate_greedy_equals_reference():
    """Greedy tokens after an ``embeds`` prompt equal the reference
    Server's."""
    ref, sref = _reference(), _serving_reference()
    model = build_model(_cfgs("reduced")[0])
    params = params_from_jax(_np_tree(ref["jparams"]))
    jtoks = np.asarray(JServer(ref["jmodel"]).generate(
        ref["jparams"], jax.tree.map(jnp.asarray, sref["prompt"]), 5))
    toks = Server(model).generate(params, _to_torch(sref["prompt"]), 5)
    assert toks.dtype == torch.int32 and toks.shape == (B, 5)
    np.testing.assert_array_equal(toks.numpy(), jtoks)


# -------------------------------------------------------------- batches

def test_input_specs_and_make_batch_match_reference():
    """Every shape kind's keys, shapes and dtypes equal the reference's;
    ``make_batch``'s embeds are N(0, 0.02^2) in the model's dtype, its
    M-RoPE ids in [0, max(seq, 4)), its labels in the vocabulary."""
    cfg, jcfg = _cfgs("reduced")
    g = torch.Generator().manual_seed(0)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec("s", kind, 48, 8)
        specs = input_specs(cfg, shape, n_workers=2)
        jspecs = jinput_specs(jcfg, JShapeSpec("s", kind, 48, 8),
                              n_workers=2)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
                for k, v in specs.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in jspecs.items()}
        batch = make_batch(cfg, shape, g, n_workers=2, device="cpu")
        jbatch = jmake_batch(jcfg, JShapeSpec("s", kind, 48, 8),
                             jax.random.key(0), n_workers=2)
        assert list(batch) == list(jbatch)
        for k, v in batch.items():
            assert tuple(v.shape) == jbatch[k].shape, k
    b = make_batch(cfg, ShapeSpec("s", "train", 48, 64), g, device="cpu")
    assert set(b) == {"embeds", "pos", "labels"}
    assert b["embeds"].dtype == torch.float32
    assert abs(b["embeds"].std().item() - 0.02) < 1e-3
    assert int(b["pos"].min()) == 0 and int(b["pos"].max()) == 47
    assert int(b["labels"].max()) < cfg.vocab
    bf = make_batch(get_config(ARCH), ShapeSpec("s", "prefill", 8, 2), g,
                    device="cpu")
    assert bf["embeds"].dtype == torch.bfloat16 and \
        tuple(bf["embeds"].shape) == (2, 8, 3584)


def test_synthetic_batches_and_group_rows(monkeypatch):
    """``SyntheticLM``'s vlm batch: embeds, M-RoPE ids ``arange(seq)`` on
    all three channels and labels (no tokens), the reference's keys and
    shapes; a prefill batch without labels; on a group, a rank's rows of
    every key are the one-process batch's."""
    cfg, jcfg = _cfgs("reduced")
    shape = ShapeSpec("t", "train", SEQ, BATCH)
    data = SyntheticLM(cfg, shape, n_workers=WORKERS, device="cpu")
    b = data.batch_at(3)
    jb = JSyntheticLM(jcfg, JShapeSpec("t", "train", SEQ, BATCH),
                      n_workers=WORKERS).batch_at(3)
    assert list(b) == list(jb) == ["embeds", "pos", "labels"]
    for k in b:
        assert tuple(b[k].shape) == jb[k].shape, k
    assert b["embeds"].dtype == torch.float32
    assert torch.equal(b["pos"], torch.arange(SEQ)[:, None].expand(
        WORKERS, BATCH // WORKERS, SEQ, 3))
    assert torch.equal(b["embeds"], data.batch_at(3)["embeds"])
    assert not torch.equal(b["embeds"], data.batch_at(4)["embeds"])
    pre = SyntheticLM(cfg, ShapeSpec("p", "prefill", SEQ, 3),
                      device="cpu").batch_at(0)
    assert list(pre) == ["embeds", "pos"] and \
        tuple(pre["embeds"].shape) == (3, SEQ, 256)
    monkeypatch.setattr(sharding, "local_workers", lambda g, n: range(1, 2))
    rank = SyntheticLM(cfg, shape, n_workers=WORKERS, device="cpu",
                       group=object()).batch_at(3)
    assert list(rank) == list(b)
    for k in b:
        assert torch.equal(rank[k], b[k][1:2]), k


# ---------------------------------------------------------------------- CLI

def test_cli_headers_equal_reference(capsys, monkeypatch):
    """The train CLI's header field for field (``device=`` aside), one
    way and two-way, and the serve CLI's line (an ``embeds`` prompt) but
    for the wall time and rate."""
    for w2s, s2w in (("top10", "identity"), ("top10+natural", "natural")):
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
