"""Parity of the port's compressor registry with the reference's, beyond
TopK, Natural and RankK (``test_torch_optim.py``, ``test_torch_rank.py``).

Every name of the reference's ``REGISTRY`` resolves in the port with
the same analytic wire bytes; TopKSVD, ColumnTopK, Damping and
RandomDropout (not in the registry) against the reference's classes on
the same inputs; ``empirical_alpha``; the reference's own compressor
properties (``tests/test_compressors.py``) as port tests; the non-2-D
fallback rule of ``resolve_compressor``; and the radius schedules.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as J
from repro.core import schedule as jschedule
from repro.dist.layerwise import resolve_compressor as jresolve_compressor
from repro.dist.layerwise import vmap_n
from repro_torch.core import compressors as C
from repro_torch.core import schedule
from repro_torch.core.norms import norm
from repro_torch.dist.layerwise import resolve_compressor
from test_torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(24, 16), (64, 48), (768, 3072), (50304, 768), (77,), (3, 5, 7)]
MATRIX_SHAPES = [s for s in SHAPES if len(s) == 2]


def _bf16_pair(shape, seed, ties=True):
    """The same bf16 values as numpy (ml_dtypes) and torch; rounded to 3
    bits of mantissa when ``ties``, so magnitudes tie often."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if ties:
        x = np.round(x * 8) / 8
    j = jnp.asarray(x, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
        torch.bfloat16)
    return j, t


def _np(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy())


def _jnp(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ------------------------------------------------------------- registry

@pytest.mark.parametrize("name", sorted(J.REGISTRY))
def test_registry_name_and_payload_bytes_equal_reference(name):
    """Every name of the reference's registry resolves (no name raises
    any more); its display name and its analytic bytes on matrices and,
    through the fallback rule, on vectors and stacks are the reference's."""
    assert sorted(C.REGISTRY) == sorted(J.REGISTRY)
    ours, theirs = C.get_compressor(name), J.get_compressor(name)
    assert ours.name == theirs.name
    for shape in SHAPES:
        a = resolve_compressor(name, shape)
        b = jresolve_compressor(name, shape)
        assert type(a).__name__ == type(b).__name__
        assert a.payload_bytes(shape, torch.bfloat16) == \
            b.payload_bytes(shape, jnp.bfloat16), shape
        assert a.payload_bytes(shape, torch.float32) == \
            b.payload_bytes(shape, jnp.float32), shape


OTHERS = {
    "coltop10": (C.ColumnTopK(0.1), J.ColumnTopK(0.1)),
    "coltop25": (C.ColumnTopK(0.25), J.ColumnTopK(0.25)),
    "damping0.5": (C.Damping(0.5), J.Damping(0.5)),
    "damping1.5": (C.Damping(1.5), J.Damping(1.5)),
    "dropout0.7": (C.RandomDropout(0.7), J.RandomDropout(0.7)),
    "svd3": (C.TopKSVD(3), J.TopKSVD(3)),
    "svd3+natural": (C.WithNatural(C.TopKSVD(3)),
                     J.WithNatural(J.TopKSVD(3))),
    "rank4": (C.RankK(rank=4), J.RankK(rank=4)),
    "rank4+natural": (C.WithNatural(C.RankK(rank=4)),
                      J.WithNatural(J.RankK(rank=4))),
}


@pytest.mark.parametrize("key", sorted(OTHERS))
def test_other_compressors_payload_bytes_and_names(key):
    ours, theirs = OTHERS[key]
    assert ours.name == theirs.name
    for shape in MATRIX_SHAPES:
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                         (torch.float32, jnp.float32)):
            assert ours.payload_bytes(shape, tdt) == \
                theirs.payload_bytes(shape, jdt), (shape, tdt)


# ------------------------------------------- each compressor, exactly

@pytest.mark.parametrize("frac", [0.1, 0.25])
@pytest.mark.parametrize("shape", [(24, 16), (48, 80)])
def test_column_topk_equals_reference(frac, shape):
    """ColumnTopK on bf16 slices with many tied column norms, over [2, 3]
    lead dims (one message each): indices, columns and the decompressed
    slice bit-equal to the reference's vmapped per-slice result."""
    j, t = _bf16_pair((2, 3) + shape, 1)
    ours, theirs = C.ColumnTopK(frac), J.ColumnTopK(frac)
    jpl = vmap_n(lambda s: theirs.compress({}, s)[0], 2)(j)
    pl, st = ours.compress({}, t, shape)
    assert st == {} and sorted(pl) == sorted(jpl) == ["cols", "indices"]
    for k in pl:
        assert pl[k].dtype == {"cols": torch.bfloat16,
                               "indices": torch.int32}[k]
        np.testing.assert_array_equal(_np(pl[k]), _jnp(jpl[k]), err_msg=k)
    got = ours.decompress(pl, t.shape, torch.float32)
    want = vmap_n(lambda p: theirs.decompress(p, shape, jnp.float32),
                  2)(jpl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gamma", [0.5, 1.0, 1.5])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_damping_equals_reference(gamma, dtype):
    j, t = _bf16_pair((2, 24, 16), 2, ties=False)
    if dtype == "float32":
        j, t = j.astype(jnp.float32), t.float()
    pl, _ = C.Damping(gamma).compress({}, t, (24, 16))
    jpl, _ = J.Damping(gamma).compress({}, j)
    assert pl.dtype == t.dtype
    np.testing.assert_array_equal(_np(pl), _jnp(jpl))
    np.testing.assert_array_equal(
        C.Damping(gamma).decompress(pl, t.shape, torch.float32).numpy(),
        np.asarray(J.Damping(gamma).decompress(jpl, j.shape, jnp.float32)))


def test_random_dropout_with_injected_keep_equals_reference():
    """The reference draws each message's keep bit from ``jax.random``;
    injected into the port, the same bits give the same payload and
    decompressed values, bit for bit."""
    j, t = _bf16_pair((6, 24, 16), 3, ties=False)
    theirs = J.RandomDropout(0.5)
    keys = jax.random.split(jax.random.key(4), 6)
    jpl, _ = jax.vmap(lambda k, s: theirs.compress(
        theirs.init(k, (24, 16), jnp.bfloat16), s))(keys, j)
    keep = np.array(jpl["keep"])
    assert 0 < keep.sum() < 6
    ours = C.RandomDropout(0.5)
    pl, _ = ours.compress({"generator": None}, t, (24, 16),
                          keep=torch.from_numpy(keep))
    np.testing.assert_array_equal(pl["keep"].numpy(), keep)
    np.testing.assert_array_equal(_np(pl["x"]), _jnp(jpl["x"]))
    np.testing.assert_array_equal(
        ours.decompress(pl, t.shape, torch.float32).numpy(),
        np.asarray(jax.vmap(lambda p: theirs.decompress(
            p, (24, 16), jnp.float32))(jpl)))


def test_random_dropout_draws_from_its_state_only():
    """Its own draws: from the generator its init seeded off the caller's
    (the same seed, the same bits), not torch's global generator (whose
    state is left as it was); a fraction near p of the messages kept."""
    x = torch.randn(4000, 3, 2)
    comp = C.RandomDropout(0.7)
    before = torch.get_rng_state()
    runs = []
    for _ in range(2):
        state = comp.init(torch.Generator().manual_seed(5), (3, 2),
                          torch.float32, (4000,))
        pl, state = comp.compress(state, x, (3, 2))
        pl2, _ = comp.compress(state, x, (3, 2))
        runs.append((pl["keep"], pl2["keep"]))
    assert torch.equal(torch.get_rng_state(), before)
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][0], runs[0][1])
    assert abs(runs[0][0].float().mean().item() - 0.7) < 0.05
    with pytest.raises(ValueError, match="Generator"):
        comp.compress(comp.init(None, (3, 2), torch.float32), x, (3, 2))


@pytest.mark.parametrize("rank", [1, 3, 5])
@pytest.mark.parametrize("natural", [False, True])
def test_topksvd_decompressed_values_match_reference(rank, natural):
    """TopKSVD's factors are unique up to the signs of singular-vector
    pairs, so the decompressed slices are compared (f32 SVDs of two
    libraries: relative 1e-5 of the slice's largest entry); Natural is
    odd, so a flipped pair decodes to the same product (relative 1e-2:
    a factor entry near a power-of-two midpoint may round apart)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, 9)).astype(np.float32)
    ours = C.TopKSVD(rank)
    theirs = J.TopKSVD(rank)
    if natural:
        ours, theirs = C.WithNatural(ours), J.WithNatural(theirs)
    pl, st = ours.compress({}, torch.from_numpy(x), (12, 9))
    jpl = jax.vmap(lambda s: theirs.compress({}, s)[0])(jnp.asarray(x))
    assert st == {} and sorted(pl) == sorted(jpl)
    for k in pl:
        assert tuple(pl[k].shape) == tuple(jpl[k].shape)
        assert str(pl[k].dtype).removeprefix("torch.") == \
            str(jpl[k].dtype)
    got = ours.decompress(pl, x.shape, torch.float32).numpy()
    want = np.asarray(jax.vmap(lambda p: theirs.decompress(
        p, (12, 9), jnp.float32))(jpl))
    tol = 1e-2 if natural else 1e-5
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_topksvd_and_rankk_payload_shapes_on_meta():
    """The wire layout's shape pass: on ``meta`` tensors TopKSVD and RankK
    give their payloads' shapes and dtypes without computing anything
    (no SVD, no NS kernel, whose wrappers refuse ``meta``)."""
    x = torch.empty((2, 3, 64, 48), dtype=torch.bfloat16, device="meta")
    pl, _ = C.TopKSVD(4).compress({}, x, (64, 48))
    assert {k: tuple(v.shape) for k, v in pl.items()} == \
        {"us": (2, 3, 64, 4), "vt": (2, 3, 4, 48)}
    assert all(v.device.type == "meta" and v.dtype == torch.float32
               for v in pl.values())
    comp = C.WithNatural(C.RankK(0.1))
    st = comp.init(None, (64, 48), torch.bfloat16, (2, 3), "meta")
    assert st["q"].shape == (2, 3, 48, 5) and st["q"].device.type == "meta"
    pl, st = comp.compress(st, x, (64, 48))
    assert {k: tuple(v.shape) for k, v in pl.items()} == {
        "p_codes": (2, 3, 320), "p_signs": (2, 3, 40),
        "q_codes": (2, 3, 240), "q_signs": (2, 3, 30)}
    assert st["q"].shape == (2, 3, 48, 5)


# ------------------------------------------------------ empirical alpha

ALPHA = {"top10": (C.TopK(0.1), J.TopK(0.1)),
         "top20": (C.TopK(0.2), J.TopK(0.2)),
         "natural": (C.Natural(), J.Natural()),
         "coltop25": OTHERS["coltop25"], "damping0.5": OTHERS["damping0.5"]}


@pytest.mark.parametrize("name", sorted(ALPHA))
def test_empirical_alpha_matches_reference(name):
    """Deterministic compressors, the same f32 message: alpha within 1e-5
    (f32 norms summed in two orders)."""
    ours, theirs = ALPHA[name]
    x = np.random.default_rng(7).standard_normal((32, 24)).astype(np.float32)
    if name == "natural":   # Natural's input is the wire's bf16
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    a = C.empirical_alpha(ours, torch.Generator().manual_seed(0),
                          torch.from_numpy(x), n_trials=2)
    b = J.empirical_alpha(theirs, jax.random.key(0), jnp.asarray(x),
                          n_trials=2)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert 0.0 < a <= 1.0


def test_empirical_alpha_of_rankk_near_reference():
    """RankK from different random sketches (``torch.Generator`` against
    ``jax.random``), warm-started over 8 trials on one message: both
    converge to the same subspace, so alpha agrees within 0.05."""
    x = np.random.default_rng(8).standard_normal((32, 24)).astype(np.float32)
    a = C.empirical_alpha(C.RankK(0.25), torch.Generator().manual_seed(0),
                          torch.from_numpy(x))
    b = J.empirical_alpha(J.RankK(0.25), jax.random.key(0), jnp.asarray(x))
    assert abs(a - b) < 0.05 and 0.0 < a < 1.0


# --------------------- the reference's properties (test_compressors.py)

def _contract_ratio(comp, x, kind="frobenius", trials=4, seed=0):
    """E||C(x)-x||^2 / ||x||^2 (should be <= 1 - alpha)."""
    shape = tuple(x.shape)
    state = comp.init(torch.Generator().manual_seed(seed), shape, x.dtype)
    tot = 0.0
    for _ in range(trials):
        payload, state = comp.compress(state, x, shape)
        xh = comp.decompress(payload, shape, torch.float32)
        tot += float(norm(xh - x.to(torch.float32), kind)) ** 2
    return tot / trials / float(norm(x, kind)) ** 2


def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


@pytest.mark.parametrize("name", sorted(C.REGISTRY))
def test_registry_roundtrip_shapes(name):
    comp = C.get_compressor(name)
    shape = (24, 16)
    x = _randn(*shape).to(torch.bfloat16)
    state = comp.init(torch.Generator().manual_seed(0), shape,
                      torch.bfloat16)
    payload, state = comp.compress(state, x, shape)
    xh = comp.decompress(payload, shape, torch.float32)
    assert xh.shape == shape and xh.dtype == torch.float32
    assert bool(torch.isfinite(xh).all())
    assert comp.payload_bytes(shape, torch.bfloat16) > 0


def test_topk_contractive_euclidean():
    x = _randn(32, 16)
    for frac in (0.05, 0.1, 0.2, 0.5):
        assert _contract_ratio(C.TopK(frac), x) <= 1.0 - frac * 0.5


def test_topksvd_alpha_matches_formula():
    """alpha = 1 - (sum_{i>K} s_i^p / sum s_i^p)^{2/p} for Schatten-p."""
    x = _randn(12, 9, seed=1)
    s = torch.linalg.svdvals(x)
    for k in (1, 3, 5):
        comp = C.TopKSVD(rank=k)
        payload, _ = comp.compress({}, x, x.shape)
        xh = comp.decompress(payload, x.shape, torch.float32)
        np.testing.assert_allclose(float(norm(xh - x, "spectral")),
                                   float(s[k]), rtol=1e-4)
        np.testing.assert_allclose(float(norm(xh - x, "nuclear")),
                                   float(torch.sum(s[k:])), rtol=1e-4)
        np.testing.assert_allclose(float(norm(xh - x, "frobenius")),
                                   float(torch.sqrt(torch.sum(s[k:] ** 2))),
                                   rtol=1e-4)


def test_column_topk_contractive_mixed_norm():
    x = _randn(16, 20, seed=2)
    comp = C.ColumnTopK(0.25)
    payload, _ = comp.compress({}, x, x.shape)
    xh = comp.decompress(payload, x.shape, torch.float32)
    kept = payload["indices"].long()
    np.testing.assert_allclose(xh[:, kept].numpy(), x[:, kept].numpy(),
                               rtol=1e-6)
    assert _contract_ratio(comp, x, kind="col_l2_dual") < 1.0


def test_dropout_damping_alpha():
    x = _randn(16, 16, seed=3)
    for g in (0.5, 1.0, 1.5):
        np.testing.assert_allclose(_contract_ratio(C.Damping(g), x,
                                                   trials=1),
                                   (1 - g) ** 2, rtol=1e-5, atol=1e-7)
    assert abs(_contract_ratio(C.RandomDropout(0.7), x, trials=64) - 0.3) \
        < 0.15


def test_rankk_approximately_contractive():
    """PowerSGD-style RankK with NS orthonormalisation and warm start:
    near the optimal rank-K residual after warm-up (Remark 11)."""
    comp = C.RankK(fraction=0.25)
    x = _randn(32, 24, seed=4)
    state = comp.init(torch.Generator().manual_seed(0), x.shape,
                      torch.float32)
    for _ in range(3):
        payload, state = comp.compress(state, x, x.shape)
    xh = comp.decompress(payload, x.shape, torch.float32)
    s = torch.linalg.svdvals(x)
    best = float(torch.sum(s[comp.rank_for(x.shape):] ** 2)
                 / torch.sum(s ** 2))
    ratio = float(norm(xh - x, "frobenius") ** 2
                  / norm(x, "frobenius") ** 2)
    assert ratio < 1.0
    assert ratio < 2.5 * best + 0.2


def test_with_natural_combo_bytes():
    """TopK+Natural / RankK+Natural payloads: float planes shrink to
    9 bits/value; indices stay int32 (Table 2 accounting)."""
    shape = (64, 48)
    top = C.WithNatural(C.TopK(0.1))
    k = top.inner.k_for(shape)
    assert top.payload_bytes(shape, torch.bfloat16) == k * 4 + k + (k + 7) // 8
    rk = C.WithNatural(C.RankK(fraction=0.1))
    r = rk.rank_for(shape)
    nn = (64 + 48) * r
    assert rk.payload_bytes(shape, torch.bfloat16) == nn + (nn + 7) // 8
    x = _randn(*shape, seed=5).to(torch.bfloat16)
    st = rk.init(torch.Generator().manual_seed(0), shape, torch.bfloat16)
    payload, st = rk.compress(st, x, shape)
    xh = rk.decompress(payload, shape, torch.float32)
    assert xh.shape == shape and not bool(torch.isnan(xh).any())
    assert sum(v.numel() * v.element_size() for v in payload.values()) \
        == rk.payload_bytes(shape, torch.bfloat16)


def test_empirical_alpha_helper():
    a = C.empirical_alpha(C.TopK(0.25), torch.Generator().manual_seed(0),
                          _randn(16, 16, seed=6))
    assert 0.25 <= a <= 1.0


# ------------------------------------------------------ the fallback rule

def test_rank_fallback_is_deterministic_and_wrapped():
    """The reference's resolve rule (``tests/test_error_feedback.py``):
    rank-type compressors on slices that are not 2-D fall back to
    TopK(0.25), keeping a requested Natural wrapper; 2-D slices keep what
    was asked for; other compressors pass through on any shape."""
    assert resolve_compressor("rank10", (128,)) == C.TopK(0.25)
    fb = resolve_compressor("rank10+natural", (128,))
    assert fb == C.WithNatural(C.TopK(0.25))
    assert resolve_compressor("rank10+natural", (4, 5, 6)) == fb
    assert resolve_compressor("rank10", (64, 32)) == C.RankK(fraction=0.1)
    assert isinstance(resolve_compressor("top10", (128,)), C.TopK)
    assert isinstance(resolve_compressor("natural", (128,)), C.Natural)
    for name in sorted(C.REGISTRY):
        for shape in SHAPES:
            assert resolve_compressor(name, shape).name == \
                jresolve_compressor(name, shape).name


# ------------------------------------------------------------ schedules

SCHED_ARGS = [(0.01, 5, 50, 0.0), (0.02, 0, 100, 0.1), (1.0, 10, 400, 0.05),
              (0.3, 3, 7, 0.0)]


@pytest.mark.parametrize("args", SCHED_ARGS)
def test_constant_and_theory_radius_equal_reference(args):
    t0, _, total, _ = args
    for s in range(total + 3):
        for ours, theirs in ((schedule.constant(t0), jschedule.constant(t0)),
                             (schedule.theory_radius(t0, total),
                              jschedule.theory_radius(t0, total))):
            got, want = ours(s), np.float32(theirs(s))
            assert isinstance(got, np.float32) and got == want


# XLA's f32 cosine is not correctly rounded (on 1.3% of random angles it
# differs from the correctly rounded one, on 17% from numpy's f32 cos);
# the port's schedule takes the correctly rounded cosine of the same f32
# angle, so a radius may differ by the cosine's last bit, scaled: within
# COS_ULPS f32 ulps (measured: 3 of 1,177 steps over these four
# schedules, at most 2 ulps apart; every other step bit-equal).
COS_ULPS = 2


@pytest.mark.parametrize("args", SCHED_ARGS)
def test_cosine_schedule_equals_reference(args):
    ours, theirs = schedule.cosine(*args), jschedule.cosine(*args)
    apart = 0
    for s in range(args[2] + 3):
        got, want = ours(s), np.float32(theirs(s))
        assert isinstance(got, np.float32)
        ulps = abs(int(got.view(np.int32)) - int(want.view(np.int32)))
        assert ulps <= COS_ULPS, (s, got, want)
        apart += ulps > 0
    assert apart <= max(1, (args[2] + 3) // 100)
