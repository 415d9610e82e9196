"""RecurrentGemma (Griffin) in the port against the reference's.

``recurrentgemma-2b`` interleaves RG-LRU recurrent blocks (a GELU gate
branch beside a causal depthwise conv and the RG-LRU) with local MQA
attention over a 2048 window, pattern (rec, rec, attn), each followed by
a GeGLU MLP; 26 layers are 8 periods and a remainder stack of (rec,
rec). On its ``reduced()`` config (one period, d_model 256, f32) and on
the remainder case ``replace(reduced, n_layers=5)`` (window 6), from the
reference's parameters, states, caches and batches carried across
through numpy:

  * the configs field for field (published, reduced, ``with_depth(2)``,
    the remainder case);
  * ``_causal_conv``, ``rglru`` and ``rglru_step`` against the
    reference's (f32, and ``rglru`` on bf16 inputs); the port's scan
    against its own step cell; a carried state;
  * the parameter tree and metas, the parameter counts, the NS buckets
    and wire of the smoke's cut against the reference's and the smoke's
    pins;
  * the loss and every gradient leaf; one two-way EF21-Muon step from the
    reference's carried state, bit-equal; 3 steps from one carried state
    on the reference model's gradients, and on the port's own (steps 0-1;
    step 2 follows TopK's picks among ties, ROADMAP Queue 3 item 2);
  * prefill and 4 decode steps (from the port's cache and from the
    reference's), decode against the full forward, greedy ``generate``;
  * ``input_specs``, ``cache_spec``, ``SyntheticLM``; the CLIs' lines.

Tolerances: the RG-LRU scan against the reference's and the step cell
within rtol 1e-4, atol 1e-5 (the reference's own scan-vs-step bar:
JAX's associative scan combines in its own order); on bf16 inputs within
one bf16 rounding of the output (2^-8 relative), the recurrence being
f32 on both sides; logits and caches within ``ATOL`` of their scale;
the loss within rtol 1e-5 and each gradient leaf within 1e-4 of its
largest entry (the dense family's).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import griffin as jgriffin
from repro_torch.models import griffin
from repro_torch.models.api import build_model
import recurrent_parity as rp
from test_torch_threads import one_torch_thread  # noqa: F401

ARCH = "recurrentgemma-2b"
ATOL = 2e-5
CUT = 2           # the smoke's training cut: 2 periods


def _rng(seed):
    return np.random.default_rng(seed)


def _lru_params(d: int, seed: int) -> dict:
    g = _rng(seed)
    return {"w_r": (g.standard_normal((d, d)) * 0.3).astype(np.float32),
            "b_r": (g.standard_normal(d) * 0.1).astype(np.float32),
            "w_i": (g.standard_normal((d, d)) * 0.3).astype(np.float32),
            "b_i": (g.standard_normal(d) * 0.1).astype(np.float32),
            "lam": np.full(d, 0.649, np.float32)}


_jrglru = jax.jit(lambda x, p: jgriffin.rglru(x, p, None))


def _both(p: dict):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("variant", ["full", "reduced", "depth2", "rem"])
def test_config_matches_reference(variant):
    rp.check_config(ARCH, variant)
    cfg = rp.cfgs(ARCH, variant)[0]
    assert cfg.block_pattern == ("rec", "rec", "attn")
    assert cfg.n_layers == {"full": 26, "reduced": 3, "depth2": 6,
                            "rem": 5}[variant]
    assert cfg.d_rnn == (2560 if variant in ("full", "depth2") else 256)


@pytest.mark.parametrize("variant, periods, rem", [
    ("full", 8, ("rec", "rec")), ("reduced", 1, ()), ("depth2", 2, ()),
    ("rem", 1, ("rec", "rec"))])
def test_periods_and_remainder(variant, periods, rem):
    """26 = 8 x 3 + 2: the remainder gets its own stack of one period."""
    model = build_model(rp.cfgs(ARCH, variant)[0])
    assert (model.n_periods, model.rem) == (periods, rem)
    params, _ = model.init(None, "meta")
    assert ("rem" in params) == bool(rem)
    if rem:
        assert sorted(params["rem"]) == ["mlp", "rec"]
        assert tuple(params["rem"]["rec"]["w_x"].shape[:2]) == (1, 2)


# --------------------------------------------------------------- primitives

@pytest.mark.parametrize("s", [1, 9])
def test_causal_conv_matches_reference(s):
    """The depthwise conv of a whole sequence and step by step from the
    tail (the previous inputs) against the reference's: the outputs and
    the tails."""
    g = _rng(s)
    x = g.standard_normal((2, s, 8)).astype(np.float32)
    w = (g.standard_normal((4, 8)) * 0.3).astype(np.float32)
    b = (g.standard_normal(8) * 0.1).astype(np.float32)
    jy, jtail = jgriffin._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b))
    y, tail = griffin._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))
    t = torch.zeros((2, 3, 8))
    steps = []
    for i in range(s):
        yi, t = griffin._causal_conv(torch.from_numpy(x[:, i:i + 1]),
                                     torch.from_numpy(w),
                                     torch.from_numpy(b), t)
        steps.append(yi)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), y.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s", [1, 7, 40, 100])
def test_rglru_matches_reference_and_its_step(s):
    """``rglru`` (the Hillis-Steele scan) against the reference's
    associative scan and against the port's own step cell, outputs and
    last state."""
    jp, tp = _both(_lru_params(8, s))
    x = _rng(100 + s).standard_normal((2, s, 8)).astype(np.float32)
    jy, jh = _jrglru(jnp.asarray(x), jp)
    y, h = griffin.rglru(torch.from_numpy(x), tp, None)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-5)
    hs, outs = torch.zeros((2, 8)), []
    for t in range(s):
        h_prev = hs
        yt, hs = griffin.rglru_step(torch.from_numpy(x[:, t]), tp, hs)
        outs.append(yt)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), y.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hs.numpy(), h.numpy(), rtol=1e-4, atol=1e-5)
    # the step cell itself against the reference's, from the same state
    jyt, jht = jgriffin.rglru_step(jnp.asarray(x[:, -1]), jp,
                                   jnp.asarray(h_prev.numpy()))
    np.testing.assert_allclose(outs[-1].numpy(), np.asarray(jyt), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jht), rtol=1e-6,
                               atol=1e-7)


def test_rglru_carried_state_matches_reference():
    """``rglru(x, h0)`` (the state as a virtual step 0) equals the
    reference's, and continuing from a split point equals the whole run."""
    jp, tp = _both(_lru_params(8, 3))
    x = _rng(4).standard_normal((1, 10, 8)).astype(np.float32)
    y_all, _ = griffin.rglru(torch.from_numpy(x), tp, None)
    y_a, h_mid = griffin.rglru(torch.from_numpy(x[:, :4]), tp, None)
    y_b, _ = griffin.rglru(torch.from_numpy(x[:, 4:]), tp, h_mid)
    jy_b, _ = jgriffin.rglru(jnp.asarray(x[:, 4:]), jp,
                             jnp.asarray(h_mid.numpy()))
    np.testing.assert_allclose(y_b.numpy(), np.asarray(jy_b), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(torch.cat([y_a, y_b], 1).numpy(),
                               y_all.numpy(), rtol=1e-4, atol=1e-5)


def test_rglru_bf16_matches_reference():
    """bf16 inputs and weights (the full model's dtype): the gates and
    the recurrence in f32 on both sides, the output rounded once to
    bf16, so the two agree within one bf16 rounding (2^-8 of each
    value, beside the f32 scan's 1e-5); the state stays f32."""
    p = _lru_params(64, 5)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    x = _rng(6).standard_normal((2, 100, 64)).astype(np.float32)
    jy, jh = _jrglru(jnp.asarray(x, jnp.bfloat16), jp)
    y, h = griffin.rglru(torch.from_numpy(x).to(torch.bfloat16), tp, None)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    jy = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), jy, rtol=2 ** -8,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-5)


def test_linear_scan_against_a_float64_loop():
    """The scan at lengths that are and are not powers of two, with
    decays down to exp(-8.6) a step (the RG-LRU's range), against a
    float64 loop."""
    g = _rng(7)
    for s in (2, 64, 129):
        a = np.exp(-8.6 * g.random((3, s, 5))).astype(np.float32)
        b = g.standard_normal((3, s, 5)).astype(np.float32)
        h, want = np.zeros((3, 5)), []
        for t in range(s):
            h = a[:, t].astype(np.float64) * h + b[:, t]
            want.append(h)
        got = griffin.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), np.stack(want, 1),
                                   rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- params and metas

@pytest.mark.parametrize("size, n_params", [
    ("reduced", 2_135_808), ("rem", 3_582_720), ("depth2", 1_169_277_440),
    ("full", 2_894_574_080)])
def test_param_tree_and_metas_match_reference(size, n_params):
    """Leaf paths in flatten order, shapes, dtypes, metas (``conv_w`` a
    spectral [4, d_rnn] matrix, ``lam`` a sign vector at 0.649) and the
    parameter count; no ``unembed`` (tied)."""
    params = rp.check_tree(ARCH, size, n_params)
    assert "unembed" not in params
    model = build_model(rp.cfgs(ARCH, size)[0])
    _, metas = model.init(None, "meta")
    assert metas["blocks"]["rec"]["conv_w"].lmo == "spectral"
    assert metas["blocks"]["rec"]["lam"].lmo == "sign"


def test_lam_is_the_reference_constant():
    """``lam`` is 0.649 at every entry, as the reference's init makes it."""
    params = rp.port(ARCH)[1]
    jp = rp.reference(ARCH)["jparams"]
    assert torch.all(params["blocks"]["rec"]["lam"] == 0.649)
    assert np.all(np.asarray(jp["blocks"]["rec"]["lam"]) == np.float32(0.649))


def test_cut_plan_equals_reference_and_smoke():
    """The smoke's training cut (every width, 2 periods, 2 workers): the
    NS buckets, wire layouts and budgets against the reference's and the
    smoke's pins."""
    smoke = rp.smoke()
    rp.check_plan(ARCH, CUT, smoke.GRIFFIN_BUCKETS, smoke.WIRE[ARCH, 3 * CUT])
    assert smoke.GRIFFIN_DEPTH == CUT


# ------------------------------------------------------- loss and gradients

@pytest.mark.parametrize("variant", ["reduced", "rem"])
def test_model_loss_and_grads_match_reference(variant):
    rp.check_loss_and_grads(ARCH, variant, rel=1e-4)


def test_two_way_step_from_carried_state_matches_reference():
    rp.check_carried_step(ARCH)


def test_three_steps_from_one_state_track_reference():
    rp.check_three_steps(ARCH)


def test_own_gradient_steps_track_reference():
    rp.check_own_gradient_steps(ARCH)


# ------------------------------------------------------------------ serving

@pytest.mark.parametrize("variant", ["reduced", "rem"])
@pytest.mark.parametrize("source", ["port", "reference"])
def test_prefill_and_decode_match_reference(variant, source):
    """Prefill's logits and cache (the RG-LRU states in f32, the conv
    tails, the attention ring: at window 6 the prompt of 10 wraps it),
    then 4 decode steps."""
    rp.check_prefill_decode(ARCH, variant, source, ATOL)


@pytest.mark.parametrize("variant", ["reduced", "rem"])
def test_decode_matches_the_full_forward(variant):
    rp.check_decode_vs_full(ARCH, variant, ATOL)


def test_generate_greedy_equals_reference():
    rp.check_generate(ARCH)


def test_cache_layout():
    """The cache: the groups' states and ring, ``h`` f32, the rest in the
    model's dtype, the ring's capacity ``min(window, max_len)``; the
    remainder group has no attention entry (the reference's None)."""
    model = build_model(rp.cfgs(ARCH, "full")[0])
    spec = model.cache_spec(8, 4160)
    assert sorted(spec) == ["blocks", "rem"] and sorted(spec["rem"]) == \
        ["rec"]
    assert tuple(spec["blocks"]["rec"]["h"].shape) == (8, 2, 8, 2560)
    assert spec["blocks"]["rec"]["h"].dtype == torch.float32
    assert tuple(spec["blocks"]["rec"]["conv"].shape) == (8, 2, 8, 3, 2560)
    assert spec["blocks"]["rec"]["conv"].dtype == torch.bfloat16
    assert tuple(spec["blocks"]["attn"]["k"].shape) == (8, 1, 8, 2048, 1,
                                                        256)
    assert tuple(model.cache_spec(2, 100)["blocks"]["attn"]["v"].shape) == \
        (8, 1, 2, 100, 1, 256)


# -------------------------------------------------------------- batches

def test_input_specs_cache_spec_and_batches_match_reference():
    rp.check_specs(ARCH, ("reduced", "full", "rem"))


def test_cli_lines_equal_reference(capsys, monkeypatch):
    rp.check_cli(ARCH, capsys, monkeypatch)
