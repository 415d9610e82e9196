"""Parity of the port's elastic participation, fault injection and
non-finite guard with the reference's (DESIGN.md §11).

Held against the JAX package on the same inputs, handed across as numpy:
the masks of every schedule and the spec errors, bit for bit
(``bernoulli(p)`` included: the port draws JAX's threefry bits in
numpy); the fault grammar, its rejects and each injection (the same
poisoned leaf, the same flipped positions and XOR bytes); the guard's
demotion and the all-poisoned skip; ten packed steps with an Explicit
table and nan, drop and flip faults from a carried state (EF state bit
for bit, x within ``X_ATOL_10``); TopK's decompress of out-of-range and
negative indices against ``jnp .at[].set``; Natural's decode of all 256
codes with both signs.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jcomp
from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.core.muon import ParamMeta as JParamMeta
from repro.dist import participation as jpart
from repro.kernels.ops import natural_decompress as jnatural_decompress
from repro.kernels.ops import pack_bits as jpack_bits
from repro.train import faults as jfaults
from repro_torch.core import compressors as comp
from repro_torch.core.muon import EF21Muon, EF21MuonConfig, ParamMeta
from repro_torch.dist import participation as part
from repro_torch.kernels.ops import natural_decompress
from repro_torch.models.api import state_from_jax
from repro_torch.train import faults
from test_torch_s2w import _np_tree, _tiny_tree

# x after ten NS-driven LMO steps: each step's f32 NS rounding (~5e-7,
# test_torch_optim.py) accumulates in X, which the gradient below does
# not read back
X_ATOL_10 = 1e-5


# ------------------------------------------------------------ schedules

@pytest.mark.parametrize("spec", ["full", "round_robin(1)", "round_robin(2)",
                                  "round_robin(3)"])
def test_masks_equal_reference(spec):
    for step in range(12):
        np.testing.assert_array_equal(
            part.participation_mask(spec, 3, step),
            np.asarray(jpart.participation_mask(spec, 3, step)))


def test_explicit_masks_equal_reference():
    masks = ((1, 0, 1), (0, 0, 0), (1, 1, 0))
    for step in range(7):
        np.testing.assert_array_equal(
            part.participation_mask(part.Explicit(masks), 3, step),
            np.asarray(jpart.participation_mask(jpart.Explicit(masks), 3,
                                                step)))


def test_bernoulli_draws_equal_jax():
    """1,000 draws over (seed, step, p, n): the port's numpy threefry
    gives ``jax.random.bernoulli``'s bits."""
    rng = np.random.default_rng(20)
    for _ in range(1000):
        seed = int(rng.integers(0, 2 ** 31))
        step = int(rng.integers(0, 2 ** 20))
        p = float(rng.choice([0.05, 0.25, 0.5, 0.7, 0.9, 1.0]))
        n = int(rng.integers(1, 9))
        want = jax.random.bernoulli(jax.random.fold_in(
            jax.random.key(seed), jnp.int32(step)), p, (n,))
        np.testing.assert_array_equal(
            part.participation_mask(f"bernoulli({p})", n, step, seed),
            np.asarray(want), err_msg=f"{seed} {step} {p} {n}")


@pytest.mark.parametrize("bad", ["bernoulli(0)", "bernoulli(1.5)",
                                 "round_robin(0)", "round_robin(9)",
                                 "nonsense", 42])
def test_spec_errors_equal_reference(bad):
    with pytest.raises(ValueError) as want:
        jpart.validate_spec(bad, 4)
    with pytest.raises(ValueError) as got:
        part.validate_spec(bad, 4)
    assert str(got.value) == str(want.value)


def test_explicit_errors_equal_reference():
    for mod in (part, jpart):
        with pytest.raises(ValueError, match="are for 2 workers"):
            mod.validate_spec(mod.Explicit(((1, 1),)), 4)
        with pytest.raises(ValueError, match=">= 1 mask"):
            mod.Explicit(())
        with pytest.raises(ValueError, match="same length"):
            mod.Explicit(((1, 0), (1,)))


def test_mask_reaches_the_device_as_bool():
    m = part.mask_to_device(np.array([True, False]), "cpu")
    assert m.dtype == torch.bool and m.tolist() == [True, False]
    assert part.mask_bcast(m, 3).shape == (2, 1, 1)


# ------------------------------------------------------------ the guard

def test_payload_finite_mask_equal_reference():
    """Only floating leaves are checked: a NaN value demotes its worker;
    a Natural code of 255 (which decodes to +-inf) does not, in both."""
    vals = np.ones((3, 4), np.float32)
    vals[1, 2] = np.nan
    codes = np.full((3, 4), 255, np.uint8)
    jpl = [{"values": jnp.asarray(vals),
            "indices": jnp.zeros((3, 4), jnp.int32)},
           {"codes": jnp.asarray(codes)}]
    tpl = [{"values": torch.from_numpy(vals),
            "indices": torch.zeros((3, 4), dtype=torch.int32)},
           {"codes": torch.from_numpy(codes)}]
    want = np.asarray(jpart.payload_finite_mask(jpl, 3))
    got = part.payload_finite_mask(tpl, 3, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert want.tolist() == [True, False, True]


# ----------------------------------------------------------- fault plans

SPEC = ("drop:w=1:steps=5-10,nan:w=0:steps=7,inf:w=2:steps=3-6,"
        "flip:steps=4:bits=16,stall:w=1:steps=5-7:ms=500,crash:step=9")


def test_parse_faults_equals_reference():
    got = faults.parse_faults(SPEC, n_workers=4, seed=3)
    want = jfaults.parse_faults(SPEC, n_workers=4, seed=3)
    for name in ("n_workers", "seed", "drops", "grad_faults", "wire_faults",
                 "stalls", "crashes"):
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(a, tuple):
            a = [dataclasses.astuple(f) for f in a]
            b = [dataclasses.astuple(f) for f in b]
        assert a == b, name


@pytest.mark.parametrize("bad", ["drop:w=9:steps=1", "drop:w=1",
                                 "nan:w=0:steps=5-5", "bogus:steps=1",
                                 "stall:w=0:steps=1:ms=0", "crash:steps=3"])
def test_parse_faults_rejects_equal_reference(bad):
    with pytest.raises(ValueError) as want:
        jfaults.parse_faults(bad, n_workers=4)
    with pytest.raises(ValueError) as got:
        faults.parse_faults(bad, n_workers=4)
    assert str(got.value) == str(want.value)


def test_drop_mask_and_activity_equal_reference():
    got = faults.parse_faults(SPEC, n_workers=4)
    want = jfaults.parse_faults(SPEC, n_workers=4)
    for step in range(12):
        np.testing.assert_array_equal(got.drop_mask(step),
                                      np.asarray(want.drop_mask(step)))
        assert got.active_any(step) == bool(want.active_any(step))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_inject_grads_poisons_the_reference_leaf(seed):
    """The leaf drawn from the plan seed, the worker row and NaN/Inf: the
    reference's, bit for bit, in and out of the window."""
    params, _ = _tiny_tree()
    rng = np.random.default_rng(seed)
    grads = {k: rng.standard_normal((3,) + v.shape).astype(np.float32)
             for k, v in params.items()}
    spec = "nan:w=0:steps=2,inf:w=2:steps=1-3"
    got_plan = faults.parse_faults(spec, 3, seed=seed)
    want_plan = jfaults.parse_faults(spec, 3, seed=seed)
    keys = sorted(grads)
    for step in range(4):
        want = want_plan.inject_grads(
            {k: jnp.asarray(v) for k, v in grads.items()}, step)
        got = got_plan.inject_grads(
            [torch.from_numpy(grads[k]) for k in keys], step)
        for k, g in zip(keys, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_inject_wire_flips_the_reference_bytes(stage):
    spec = "flip:steps=3:bits=16,flip:steps=2-5:bits=500"
    got_plan = faults.parse_faults(spec, 2, seed=5)
    want_plan = jfaults.parse_faults(spec, 2, seed=5)
    buf = np.random.default_rng(stage).integers(0, 256, (2, 300),
                                                dtype=np.uint8)
    for step in range(6):
        want = want_plan.inject_wire(jnp.asarray(buf), step, stage)
        got = got_plan.inject_wire(torch.from_numpy(buf.copy()), step,
                                   stage)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f32 = torch.ones((2, 8))
    assert got_plan.inject_wire(f32, 3) is f32
    u8 = torch.zeros((2, 8), dtype=torch.uint8)
    assert got_plan.inject_wire(u8, 3, 0, "s2w") is u8


def test_host_crash_and_stall_follow_the_reference():
    got = faults.parse_faults("stall:w=0:steps=5-7:ms=250,crash:step=9", 2)
    want = jfaults.parse_faults("stall:w=0:steps=5-7:ms=250,crash:step=9",
                                2)
    for step in range(10):
        for attempt in (0, 1):
            assert got.stall_ms(step, attempt) == want.stall_ms(step,
                                                                attempt)
    got.host_crash(9, start_step=3)     # a resumed run: no exit
    assert faults.CRASH_EXIT == jfaults.CRASH_EXIT == 43


# ------------------------------------------------- the step, elastic

def _grad_const_jax(params, c):
    # loss Σ c·p, its gradient c: the EF state does not read X back, so
    # it stays bit-equal over many steps while X drifts by NS rounding
    return sum(jnp.sum(c[k] * p) for k, p in params.items()), dict(c)


def _grad_const_torch(params, c):
    return sum(torch.sum(c[k] * p) for k, p in params.items()), dict(c)


def _coeffs(params, seed, n_workers=2):
    return {k: np.random.default_rng(seed + i).standard_normal(
        (n_workers,) + v.shape).astype(np.float32)
        for i, (k, v) in enumerate(params.items())}


def _pair(w2s="top10", s2w="identity", n_workers=2, **kw):
    params, metas = _tiny_tree()
    cfg = dict(n_workers=n_workers, beta=0.5, w2s=w2s, s2w=s2w, **kw)
    jkw = dict(cfg)
    if isinstance(kw.get("participation"), part.Explicit):
        jkw["participation"] = jpart.Explicit(kw["participation"].masks)
    jopt = JEF21Muon(JEF21MuonConfig(use_pallas=False, **jkw))
    topt = EF21Muon(EF21MuonConfig(**cfg))
    jmetas = {k: JParamMeta(*m) for k, m in metas.items()}
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    jstate = jopt.init(jax.random.key(0),
                       {k: jnp.asarray(v) for k, v in params.items()},
                       jmetas)
    return params, jopt, jmetas, topt, tmetas, jstate


def _assert_ef_equal(tstate, jstate):
    for key in ("g_w", "m_w", "g_server"):
        for k in jstate[key]:
            np.testing.assert_array_equal(
                tstate[key][k].numpy(), np.asarray(jstate[key][k]),
                err_msg=f"{key}/{k}")


def _assert_x_close(tstate, jstate, atol):
    for k in jstate["x"]:
        np.testing.assert_allclose(tstate["x"][k].numpy(),
                                   np.asarray(jstate["x"][k]), rtol=0,
                                   atol=atol, err_msg=f"x/{k}")


@pytest.mark.parametrize("workers_poisoned", [(0,), (0, 1)])
def test_guard_demotes_and_skips_like_reference(workers_poisoned):
    """NaN gradients on one worker: it is demoted, its G_j and M_j frozen
    bit for bit; on every worker: the step is skipped, X and g_server
    stay. From the reference's state after one step, both sides."""
    spec = ",".join(f"nan:w={w}:steps=1:leaf=2" for w in workers_poisoned)
    params, jopt, jmetas, topt, tmetas, jstate = _pair()
    jf, tf = (jfaults.parse_faults(spec, 2), faults.parse_faults(spec, 2))
    jstep = jax.jit(lambda s, c, t, f=jopt.make_step(jmetas, faults=jf):
                    f(s, _grad_const_jax, c, t))
    tstep = topt.make_step(tmetas, faults=tf)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in
                               _coeffs(params, 100).items()}, 0.02)
    tstate = state_from_jax(_np_tree(jstate))
    before = state_from_jax(_np_tree(jstate))
    c = _coeffs(params, 200)
    jstate, jaux = jstep(jstate, {k: jnp.asarray(v) for k, v in c.items()},
                         0.04)
    tstate, taux = tstep(tstate, _grad_const_torch,
                         {k: torch.from_numpy(v) for k, v in c.items()},
                         0.04)
    n_left = 2 - len(workers_poisoned)
    assert int(taux["n_participants"]) == int(jaux["n_participants"]) \
        == n_left
    assert bool(taux["skipped"]) == bool(jaux["skipped"]) == (n_left == 0)
    np.testing.assert_array_equal(taux["participation"].numpy(),
                                  np.asarray(jaux["participation"]))
    _assert_ef_equal(tstate, jstate)
    for w in workers_poisoned:
        for key in ("g_w", "m_w"):
            for k in params:
                assert torch.equal(tstate[key][k][w], before[key][k][w])
    if n_left == 0:
        for key in ("x", "g_server"):
            for k in params:
                assert torch.equal(tstate[key][k], before[key][k])
    _assert_x_close(tstate, jstate, X_ATOL_10)


@pytest.mark.parametrize("w2s", ["top10", "top10+natural"])
def test_ten_steps_with_faults_and_an_explicit_table(w2s):
    """Ten packed steps (identity hook, the staged wire) from the
    reference's state after one step, with an Explicit table (an absent
    worker, an empty step) and nan, drop and flip faults: participants,
    skips and the EF state bit for bit every step, x within X_ATOL_10
    at the end. The flips land in values, indices (decoded to
    out-of-range and wrapped positions) and codes alike, and can make a
    value subnormal: XLA's CPU backend flushes subnormals to zero where
    PyTorch keeps them, so the port's steps run with the flush on here
    (``torch.set_flush_denormal``), as the reference's do."""
    table = part.Explicit(((1, 1), (1, 0), (1, 1), (0, 0), (1, 1), (0, 1)))
    spec = ("nan:w=0:steps=2,drop:w=1:steps=4-6,flip:steps=3:bits=64,"
            "flip:steps=6-8:bits=200,inf:w=1:steps=8")
    params, jopt, jmetas, topt, tmetas, jstate = _pair(
        w2s=w2s, participation=table)
    jf, tf = jfaults.parse_faults(spec, 2), faults.parse_faults(spec, 2)
    hook = lambda t: t      # noqa: E731
    jstep = jax.jit(lambda s, c, t, f=jopt.make_step(
        jmetas, reshard_payloads=hook, faults=jf):
        f(s, _grad_const_jax, c, t))
    tstep = topt.make_step(tmetas, reshard_payloads=hook, faults=tf)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in
                               _coeffs(params, 100).items()}, 0.02)
    tstate = state_from_jax(_np_tree(jstate))
    for s in range(10):
        c = _coeffs(params, 300 + 10 * s)
        t = 0.02 * (1 + s % 3)
        jstate, jaux = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in c.items()}, t)
        assert torch.set_flush_denormal(True)
        try:
            tstate, taux = tstep(tstate, _grad_const_torch,
                                 {k: torch.from_numpy(v)
                                  for k, v in c.items()}, t)
        finally:
            torch.set_flush_denormal(False)
        assert int(taux["n_participants"]) == int(jaux["n_participants"]), s
        assert bool(taux["skipped"]) == bool(jaux["skipped"]), s
        _assert_ef_equal(tstate, jstate)
    assert tstate["step"] == int(jstate["step"]) == 11
    _assert_x_close(tstate, jstate, X_ATOL_10)


# --------------------------------------------------- decode edge cases

@pytest.mark.parametrize("n,seed", [(50, 0), (997, 1), (4096, 2)])
def test_topk_decompress_drops_and_wraps_like_jax(n, seed):
    """Indices in [-2n, 2n), as a flipped wire can decode them: negative
    ones wrap once, the rest outside [0, n) are dropped, as the
    reference's ``.at[].set`` does (CPU; indices made distinct after the
    wrap, where the card's scatter promises no order)."""
    rng = np.random.default_rng(seed)
    k = max(1, n // 10)
    raw = rng.choice(np.arange(-2 * n, 2 * n), size=(3, k), replace=False)
    wrapped = np.where(raw < 0, raw + n, raw)
    for row in range(3):       # distinct positions among the kept ones
        keep = (wrapped[row] >= 0) & (wrapped[row] < n)
        _, first = np.unique(wrapped[row][keep], return_index=True)
        dup = np.ones(keep.sum(), bool)
        dup[first] = False
        raw[row][np.flatnonzero(keep)[dup]] = 3 * n   # dropped anyway
    idx = raw.astype(np.int32)
    vals = rng.standard_normal((3, k)).astype(np.float32)
    jt = jcomp.TopK(0.1)
    want = np.stack([np.asarray(jt.decompress(
        {"values": jnp.asarray(vals[r], jnp.bfloat16),
         "indices": jnp.asarray(idx[r])}, (n,), jnp.float32))
        for r in range(3)])
    got = comp.TopK(0.1).decompress(
        {"values": torch.from_numpy(vals).to(torch.bfloat16),
         "indices": torch.from_numpy(idx)}, (3, n), torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.any(raw < -n) and np.any(raw >= n) and np.any(
        (raw < 0) & (raw >= -n))


def test_all_natural_codes_decode_like_reference():
    """Every code 0..255 with both signs, as a flipped wire can carry
    them (the encoder emits 0..254): the reference's bits, +-inf for
    code 255 included."""
    codes = np.tile(np.arange(256, dtype=np.uint8), 2)
    signs = np.repeat(np.array([0, 1], np.uint8), 256)
    jsigns = jpack_bits(jnp.asarray(signs), use_pallas=False)
    want = np.asarray(jnatural_decompress(jnp.asarray(codes), jsigns,
                                          (512,), use_pallas=False))
    got = natural_decompress(torch.from_numpy(codes)[None],
                             torch.from_numpy(np.array(jsigns))[None],
                             (512,))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    assert np.isinf(want[255].astype(np.float32))
