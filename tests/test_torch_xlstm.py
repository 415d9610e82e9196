"""xLSTM in the port against the reference's.

``xlstm-1.3b`` is xLSTM[7:1]: periods of 7 mLSTM blocks (matrix memory,
exponential gates, the chunkwise-parallel form in training and prefill,
the exact cell in decode) and 1 sLSTM block (scalar memory, block-diagonal
recurrent weights ``r_gates`` [.., 4, H, hd, hd], a serial scan), an
untied unembedding. On its ``reduced()`` config (one period, d_model
256, 4 heads of 128, f32), from the reference's parameters, states,
caches and batches carried across through numpy:

  * the configs field for field (published, reduced, ``with_depth(1)``);
  * ``mlstm_chunkwise`` against the reference's (chunks of 4, 16 and 256,
    ragged tails, a carried state; f32, and bf16 with its rounding
    points), ``mlstm_step`` and ``slstm_step`` against the reference's,
    the chunkwise form against the port's own step cell, extreme gates;
  * the parameter tree and metas (``r_gates``' 4 stack dims), the
    parameter counts, the NS buckets and wire of the smoke's cut against
    the reference's and the smoke's pins;
  * the loss and every gradient leaf, each as close to float64 as the
    reference's; one two-way EF21-Muon step from the reference's carried
    state, bit-equal; 3 steps from one carried state on the reference
    model's gradients, and on the port's own (steps 0-1);
  * prefill and 4 decode steps (from the port's cache and from the
    reference's), decode against the full forward, greedy ``generate``;
  * ``input_specs``, ``cache_spec``, ``SyntheticLM``; the CLIs' lines.

Tolerances. The mLSTM's normaliser ``max(|q.n|, exp(-m))`` is small
where q is near-orthogonal to n, and divides: f32 rounding in another
summation order is amplified there, so the reference's own chunkwise and
step forms agree only within 2e-3 (``tests/test_recurrent_models.py``),
and on reduced xlstm's first batch the reference's gradients and the
port's each sit up to ~3e-3 (relative to each leaf's largest entry;
embed's reaches 117) from the port's float64 gradients, the reference's
the further on most leaves. So: the loss within rtol 1e-5; each
gradient leaf within
``GRAD_REL`` of its largest entry, and the port's distance from float64
at most ``F64_RATIO`` times the reference's; logits and caches within
``SERVE_REL`` of their scale (``recurrent_parity.close``); the
functions on random inputs within 1e-5 (f32) or one bf16 rounding of h
(bf16).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jxlstm
from repro_torch.dist.layerwise import tree_get
from repro_torch.models import xlstm
from repro_torch.models.api import build_model
from repro_torch.train.trainer import Trainer, TrainerConfig
import recurrent_parity as rp
from test_torch_threads import one_torch_thread  # noqa: F401

ARCH = "xlstm-1.3b"
CUT = 1           # the smoke's training cut: 1 period
GRAD_REL, GRAD_FLOOR = 5e-3, 1e-8
F64_RATIO = 3.0
SERVE_REL = 2e-3


def _rng(seed):
    return np.random.default_rng(seed)


def _mlstm_inputs(s: int, seed: int, hd: int = 8, gate_shift: float = 2.0):
    g = _rng(seed)
    b, h = 2, 2
    q, k, v = (g.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    li = g.standard_normal((b, s, h)).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(
        g.standard_normal((b, s, h)).astype(np.float32) + gate_shift)))
    return q, k, v, li, lf


def _zero_state(b=2, h=2, hd=8):
    return (np.zeros((b, h, hd, hd), np.float32),
            np.zeros((b, h, hd), np.float32),
            np.full((b, h), -1e30, np.float32))


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("variant", ["full", "reduced", "depth1"])
def test_config_matches_reference(variant):
    rp.check_config(ARCH, variant)
    cfg = rp.cfgs(ARCH, variant)[0]
    assert cfg.block_pattern == ("m",) * 7 + ("s",)
    assert cfg.n_layers == {"full": 48, "reduced": 8, "depth1": 8}[variant]
    model = build_model(cfg)
    assert (model.n_periods, model.n_m, model.n_s) == (
        6 if variant == "full" else 1, 7, 1)


def test_a_depth_off_the_pattern_is_refused():
    cfg = dataclasses.replace(rp.cfgs(ARCH, "reduced")[0], n_layers=5)
    with pytest.raises(ValueError, match="block_pattern"):
        build_model(cfg)


# --------------------------------------------------------------- primitives

@pytest.mark.parametrize("s, chunk", [(1, 4), (9, 4), (40, 16), (40, 256),
                                      (50, 16)])
def test_mlstm_chunkwise_matches_reference(s, chunk):
    """h and the final state (c, n, m) against the reference's, from a
    zero state and from a carried one; a ragged tail (s mod chunk != 0)
    padded with log_i = -1e30 on both sides."""
    q, k, v, li, lf = _mlstm_inputs(s, s + chunk)
    jh, js = jxlstm.mlstm_chunkwise(*map(jnp.asarray, (q, k, v, li, lf)),
                                    chunk=chunk)
    h, st = xlstm.mlstm_chunkwise(*map(torch.from_numpy, (q, k, v, li, lf)),
                                  chunk=chunk)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(st, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    q2, k2, v2, li2, lf2 = _mlstm_inputs(7, 99)
    jh2, _ = jxlstm.mlstm_chunkwise(*map(jnp.asarray, (q2, k2, v2, li2, lf2)),
                                    state=js, chunk=chunk)
    h2, _ = xlstm.mlstm_chunkwise(*map(torch.from_numpy,
                                       (q2, k2, v2, li2, lf2)),
                                  state=st, chunk=chunk)
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh2), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("s, chunk", [(40, 16), (300, 256)])
def test_mlstm_chunkwise_bf16_matches_reference(s, chunk):
    """bf16 q, k, v (the full model's dtype): the products take f32
    copies of bf16 operands (the reference's ``preferred_element_type``),
    and the scores, D, the carried c, n and the state weights are
    rounded to bf16 at the reference's points only. h comes out bf16 on
    both sides: within one bf16 rounding at its scale (2^-8 of max |h|),
    fewer than 1% of its entries apart (measured: 0 of 10,240 at 40 steps,
    0.02% at 300), the f32 state within 1e-5. The same inputs without the
    rounding points (every intermediate f32) miss that bound by far
    (measured 3.6e-2 and 1.7e-1 of the scale, 55% of the entries)."""
    q, k, v, li, lf = _mlstm_inputs(s, 7, hd=64)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    gates = (torch.from_numpy(li), torch.from_numpy(lf))
    jh, js = jxlstm.mlstm_chunkwise(*jb, jnp.asarray(li), jnp.asarray(lf),
                                    chunk=chunk)
    h, st = xlstm.mlstm_chunkwise(*tb, *gates, chunk=chunk)
    assert h.dtype == torch.bfloat16 and st[0].dtype == torch.float32
    want = np.asarray(jh.astype(jnp.float32))
    bound = 2 ** -8 * np.max(np.abs(want))
    got = h.float().numpy()
    assert np.max(np.abs(got - want)) <= bound
    assert np.mean(got != want) < 0.01
    for a, b in zip(st, js):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b)) <= 1e-5 * max(
            1.0, np.max(np.abs(b)))
    no_points = xlstm.mlstm_chunkwise(*[a.float() for a in tb], *gates,
                                      chunk=chunk)[0].to(torch.bfloat16)
    assert np.max(np.abs(no_points.float().numpy() - want)) > 4 * bound


def test_mlstm_step_matches_reference():
    q, k, v, li, lf = _mlstm_inputs(3, 5)
    st = tuple(map(torch.from_numpy, _zero_state()))
    jst = tuple(map(jnp.asarray, _zero_state()))
    for t in range(3):
        h, st = xlstm.mlstm_step(*(torch.from_numpy(a[:, t])
                                   for a in (q, k, v, li, lf)), st)
        jh, jst = jxlstm.mlstm_step(*(jnp.asarray(a[:, t])
                                      for a in (q, k, v, li, lf)), jst)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-6)
        for a, b in zip(st, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("s, chunk", [(17, 4), (40, 16)])
def test_mlstm_chunkwise_equals_its_step_cell(s, chunk):
    """The port's chunkwise form against its sequential cell, h and the
    state in the destabilised scale (c exp(m)), within the reference's own
    bar (2e-3)."""
    q, k, v, li, lf = _mlstm_inputs(s, 11)
    hc, (c, n, m) = xlstm.mlstm_chunkwise(
        *map(torch.from_numpy, (q, k, v, li, lf)), chunk=chunk)
    st, outs = tuple(map(torch.from_numpy, _zero_state())), []
    for t in range(s):
        h1, st = xlstm.mlstm_step(*(torch.from_numpy(a[:, t])
                                    for a in (q, k, v, li, lf)), st)
        outs.append(h1)
    np.testing.assert_allclose(hc.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        (c * torch.exp(m)[..., None, None]).numpy(),
        (st[0] * torch.exp(st[2])[..., None, None]).numpy(),
        rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("li_value, lf_value", [(30.0, -30.0),
                                                (-40.0, -0.001)])
def test_mlstm_stability_extreme_gates(li_value, lf_value):
    """Log-space stabilisation: no NaN or inf for a huge input gate with a
    tiny forget gate, and for a tiny input gate with a saturated forget
    gate (the reference's test), nor in the gradients; the finite -1e30
    masks keep ``-inf - -inf`` out."""
    g = _rng(0)
    q, k, v = (torch.from_numpy(g.standard_normal((1, 32, 2, 4)).astype(
        np.float32)).requires_grad_(True) for _ in range(3))
    li = torch.full((1, 32, 2), li_value)
    lf = torch.full((1, 32, 2), lf_value)
    h, st = xlstm.mlstm_chunkwise(q, k, v, li, lf, chunk=8)
    assert torch.isfinite(h).all() and all(torch.isfinite(a).all()
                                           for a in st)
    h.sum().backward()
    assert all(torch.isfinite(a.grad).all() for a in (q, k, v))
    jh, _ = jxlstm.mlstm_chunkwise(*(jnp.asarray(a.detach().numpy())
                                     for a in (q, k, v, li, lf)), chunk=8)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                               rtol=1e-5, atol=1e-5)


def test_slstm_step_matches_reference():
    """Three sLSTM steps from the block's initial state (n = 1e-6, m =
    -1e30) against the reference's: every state leaf."""
    cfg = rp.cfgs(ARCH, "reduced")[0]
    d, nh = cfg.d_model, cfg.n_heads
    g = _rng(3)
    p = {"r_gates": (g.standard_normal((4, nh, d // nh, d // nh)) * 0.1
                     ).astype(np.float32),
         "b_i": (g.standard_normal(d) * 0.1).astype(np.float32),
         "b_f": np.full(d, 4.0, np.float32)}
    gx = g.standard_normal((3, 2, 4, d)).astype(np.float32)
    z = np.zeros((2, d), np.float32)
    st = tuple(map(torch.from_numpy, (z, z + 1e-6, z, z - 1e30)))
    jst = tuple(map(jnp.asarray, (z, z + 1e-6, z, z - 1e30)))
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    for t in range(3):
        st = xlstm.slstm_step(cfg, tp, torch.from_numpy(gx[t]), st)
        jst = jxlstm.slstm_step(cfg, jp, jnp.asarray(gx[t]), jst)
        for a, b in zip(st, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


# ------------------------------------------------------- params and metas

@pytest.mark.parametrize("size, n_params", [
    ("reduced", 9_177_656), ("depth1", 772_689_976),
    ("full", 3_605_903_696)])
def test_param_tree_and_metas_match_reference(size, n_params):
    """Leaf paths in flatten order, shapes, dtypes, metas (the untied
    ``unembed``'s sign LMO, ``r_gates``' 4 stack dims) and the parameter
    count."""
    rp.check_tree(ARCH, size, n_params)
    _, metas = build_model(rp.cfgs(ARCH, size)[0]).init(None, "meta")
    assert metas["unembed"].lmo == "sign"
    assert metas["s_blocks"]["r_gates"].stack_dims == 4


def test_cut_plan_equals_reference_and_smoke():
    """The smoke's training cut (every width, 1 period, 2 workers): the
    NS buckets (the sLSTM's w_gates shares the mLSTM's w_up bucket),
    wire layouts and budgets against the reference's and the smoke's
    pins."""
    smoke = rp.smoke()
    rp.check_plan(ARCH, CUT, smoke.XLSTM_BUCKETS, smoke.WIRE[ARCH, 8 * CUT])
    assert smoke.XLSTM_DEPTH == CUT


# ------------------------------------------------------- loss and gradients

def test_model_loss_and_grads_match_reference():
    rp.check_loss_and_grads(ARCH, "reduced", rel=GRAD_REL, floor=GRAD_FLOOR)


def test_gradients_as_close_to_float64_as_the_reference():
    """Against the port's float64 gradients on the same params and batch,
    the port's f32 gradients are at most F64_RATIO times as far as the
    reference's, over the leaves whose gradient exceeds 1e-6 (the
    sLSTM's b_i gradient, ~1e-9, is rounding noise on both sides)."""
    ref = rp.reference(ARCH)
    jb = jax.tree.map(lambda v: v[0], ref["batches"][0])
    _, jgrads = ref["jgrad"](ref["jparams"], jb)
    model, params = rp.port(ARCH)
    _, g32 = Trainer(model, TrainerConfig(), device="cpu")._grad_and_loss(
        params, rp.to_torch(jb))
    m64 = build_model(dataclasses.replace(model.cfg, dtype="float64"))
    p64 = jax.tree.map(lambda a: torch.from_numpy(np.asarray(
        a, np.float64)), rp.np_tree(ref["jparams"]))
    _, g64 = Trainer(m64, TrainerConfig(), device="cpu")._grad_and_loss(
        p64, rp.to_torch(jb))
    ours = theirs = 0.0
    for path, jg in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        key = tuple(k.key for k in path)
        truth = tree_get(g64, key).numpy()
        scale = np.max(np.abs(truth))
        if scale < 1e-6:
            continue
        ours = max(ours, np.max(np.abs(tree_get(g32, key).numpy() - truth))
                   / scale)
        theirs = max(theirs, np.max(np.abs(np.asarray(jg) - truth)) / scale)
    assert ours <= F64_RATIO * theirs, (ours, theirs)


def test_two_way_step_from_carried_state_matches_reference():
    rp.check_carried_step(ARCH)


def test_three_steps_from_one_state_track_reference():
    rp.check_three_steps(ARCH)


def test_own_gradient_steps_track_reference():
    rp.check_own_gradient_steps(ARCH)


# ------------------------------------------------------------------ serving

@pytest.mark.parametrize("source", ["port", "reference"])
def test_prefill_and_decode_match_reference(source):
    """Prefill's logits and cache (every mLSTM block's c, n, m and every
    sLSTM block's c, n, h, m, all f32), then 4 decode steps."""
    rp.check_prefill_decode(ARCH, "reduced", source, SERVE_REL)


def test_prefill_ignores_the_carried_state():
    """As the reference's, prefill starts every block from a zero state,
    whatever the cache holds: a cache of ones gives the same logits and
    state as a cache of zeros."""
    model, params = rp.port(ARCH)
    toks = torch.from_numpy(rp.serving_reference(ARCH)["tokens"][:, :8]).to(
        torch.int64)
    a, ca = model.prefill(params, {"tokens": toks},
                          model.init_cache(2, 16, "cpu"))
    ones = model.init_cache(2, 16, "cpu")
    for grp in ones.values():
        for t in grp.values():
            t.fill_(1.0)
    b, cb = model.prefill(params, {"tokens": toks}, ones)
    assert torch.equal(a, b)
    for g in ca:
        for k in ca[g]:
            assert torch.equal(ca[g][k], cb[g][k]), (g, k)


def test_decode_matches_the_full_forward():
    rp.check_decode_vs_full(ARCH, "reduced", SERVE_REL)


def test_decode_vs_full_forward_at_depth_float64():
    """At 6 periods (48 layers, the published depth, reduced widths) the
    f32 gap between decode and the full forward grows (each layer's mLSTM
    normaliser amplifies the last one's rounding); computed in float64
    (``common.acc_dtype``: the recurrences follow the model's dtype) the
    two forms agree but for the logits' final f32 cast. Hence the smoke
    holds xlstm's full-width decode against its full forward in
    float64."""
    cfg = dataclasses.replace(rp.cfgs(ARCH, "reduced")[0], n_layers=48)
    s, n = 64, 3
    toks = torch.from_numpy(_rng(5).integers(0, cfg.vocab, (2, s + n)))
    gaps = {}
    for dt in ("float32", "float64"):
        model = build_model(dataclasses.replace(cfg, dtype=dt))
        params, _ = model.init(torch.Generator().manual_seed(0), "cpu")
        cache = model.init_cache(2, s + n, "cpu")
        assert cache["m_blocks"]["c"].dtype == (torch.float64 if dt ==
                                                "float64" else torch.float32)
        _, cache = model.prefill(params, {"tokens": toks[:, :s]}, cache)
        dec = []
        for i in range(n):
            lg, cache = model.decode_step(
                params, {"token": toks[:, s + i:s + i + 1], "t": s + i},
                cache)
            dec.append(lg)
        with torch.inference_mode():
            h = model.hidden(params, {"tokens": toks})
        gaps[dt] = max((d - (h[:, s + i].to(torch.float32)
                             @ params["unembed"].to(torch.float32))
                        ).abs().max().item() for i, d in enumerate(dec))
    assert gaps["float64"] <= 1e-5, gaps
    assert gaps["float32"] > 10 * gaps["float64"], gaps


def test_generate_greedy_equals_reference():
    rp.check_generate(ARCH)


def test_cache_layout():
    """The cache: all f32, the mLSTM's matrix memory [P, 7, B, H, hd, hd]
    (hd 1024 at full width: 16 MiB a row and block), nothing that grows
    with the sequence."""
    model = build_model(rp.cfgs(ARCH, "full")[0])
    spec = model.cache_spec(8, 2112)
    assert tuple(spec["m_blocks"]["c"].shape) == (6, 7, 8, 4, 1024, 1024)
    assert tuple(spec["m_blocks"]["m"].shape) == (6, 7, 8, 4)
    assert tuple(spec["s_blocks"]["h"].shape) == (6, 1, 8, 2048)
    assert all(t.dtype == torch.float32 for g in spec.values()
               for t in g.values())
    assert model.cache_spec(8, 10 ** 6)["m_blocks"]["c"].shape == \
        spec["m_blocks"]["c"].shape


# -------------------------------------------------------------- batches

def test_input_specs_cache_spec_and_batches_match_reference():
    rp.check_specs(ARCH)


def test_cli_lines_equal_reference(capsys, monkeypatch):
    rp.check_cli(ARCH, capsys, monkeypatch)
