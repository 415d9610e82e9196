"""The port's f32 adds of the estimates and of the server's fold against
the reference's bits, NaNs and signed zeros included.

The reference runs on the CPU, where XLA keeps a NaN operand's payload,
quieted, and its compiled fold is ``(sum_j d_j) * fl(1/n)`` fused with
the add into one rounding (``jnp.mean``), or a division and an add (the
elastic arm's ``sum / count``). ``kernels.natural_pack.add_f32`` and
``fold_f32`` are those operations; their plain versions (which the CPU
runs) are held here against JAX: on ``chip_smoke.py``'s ``NAN_*``
constants, on every pair of special values, on 1 to 7 workers and on
signed zeros. Then one step of the port against one of the reference,
from a carried state with NaN payloads and the guard off: the fold with
a NaN in g_server and in a worker's payload (the sum's NaN wins), and
E + delta with a NaN in both (the estimate's wins, but a TopK delta's
wins over it), in the EF21 round, the EF21-P leg and the rejoin's
replay. Before this, the port's fold of 3 workers differed from the
reference's in the last bit of ~40% of the elements (``torch.mean``
divides; XLA multiplies by the reciprocal in one fused rounding).
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.core.muon import ParamMeta as JParamMeta
from repro_torch.core.muon import EF21Muon, EF21MuonConfig, ParamMeta
from repro_torch.kernels import natural_pack as nat
from repro_torch.kernels.ref import add_f32_ref, fold_f32_ref
from repro_torch.models.api import state_from_jax
from test_torch_s2w import (_coeffs, _grad_jax, _grad_torch, _jbatch,
                            _np_tree, _tbatch, _tiny_tree)
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

# quiet and signalling NaNs of both signs, infinities, signed zeros, ones
# and a large finite value: every pair of them goes through the add
SPECIALS = (0x7FC00000, 0xFFC00000, 0x7FC00123, 0xFFE00456, 0x7F800001,
            0xFF800789, 0x7FA00000, 0xFFBFFFFF, 0x7F800000, 0xFF800000,
            0x00000000, 0x80000000, 0x3F800000, 0xBF800000, 0x7F7FFFFF)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f32(bits) -> np.ndarray:
    return np.asarray(bits, np.uint32).view(np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32)


def _jax_add(a, b):
    return np.asarray(jax.jit(lambda x, y: x + y)(a, b))


def _jax_mean_fold(g, d):
    return np.asarray(jax.jit(lambda g, d: g + jnp.mean(d, axis=0))(g, d))


def _jax_elastic_fold(g, d, c):
    return np.asarray(jax.jit(lambda g, d, c: g + jnp.sum(d, axis=0) / c)(
        g, d, np.float32(c)))


# ----------------------------------------------------- the plain versions

def test_add_f32_gives_the_smokes_constants():
    sm = _smoke()
    w, delta = _f32(sm.NAN_ADD_W), _f32(sm.NAN_ADD_DELTA)
    want = _bits(_jax_add(w, delta))
    assert tuple(int(v) for v in want) == sm.NAN_ADD_WANT
    np.testing.assert_array_equal(_bits(nat.add_f32(_t(w), _t(delta))), want)
    a = _t(w.copy())
    assert nat.add_f32(a, _t(delta), out=a) is a       # in place
    np.testing.assert_array_equal(_bits(a), want)


@pytest.mark.parametrize("elastic", [False, True])
def test_fold_f32_gives_the_smokes_constants(elastic):
    sm = _smoke()
    g, d = _f32(sm.NAN_FOLD_G), _f32(sm.NAN_FOLD_D).reshape(2, -1)
    count = (torch.tensor(sm.NAN_FOLD_COUNT, dtype=torch.float32)
             if elastic else int(sm.NAN_FOLD_COUNT))
    want = (_jax_elastic_fold(g, d, sm.NAN_FOLD_COUNT) if elastic
            else _jax_mean_fold(g, d))
    assert tuple(int(v) for v in _bits(want)) == sm.NAN_FOLD_WANT
    np.testing.assert_array_equal(_bits(nat.fold_f32(_t(g), _t(d), count)),
                                  _bits(want))


def test_add_f32_on_every_pair_of_special_values():
    """NaN payloads (the first operand's before the second's, quieted),
    inf - inf (0xFFC00000), signed zeros: all 225 ordered pairs."""
    a, b = np.meshgrid(_f32(SPECIALS), _f32(SPECIALS), indexing="ij")
    want = _bits(_jax_add(a.ravel(), b.ravel()))
    np.testing.assert_array_equal(
        _bits(add_f32_ref(_t(a.ravel()), _t(b.ravel()))), want)
    # torch's own add keeps the second NaN where both are NaN
    assert np.any(_bits(_t(a.ravel()) + _t(b.ravel())) != want)


def test_add_f32_repeats_the_smaller_operand_over_leading_rows():
    """The replay's one delta for every worker's W_j, either operand."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 5, 8)).astype(np.float32)
    w.reshape(3, -1)[:, :len(SPECIALS)] = _f32(SPECIALS)
    delta = rng.standard_normal((5, 8)).astype(np.float32)
    delta.reshape(-1)[:len(SPECIALS)] = _f32(SPECIALS[::-1])
    for x, y in ((w, delta), (delta, w)):
        np.testing.assert_array_equal(_bits(add_f32_ref(_t(x), _t(y))),
                                      _bits(_jax_add(x, y)))


def _fold_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal((n, 4096)) * 1e3).astype(np.float32)
    g = rng.standard_normal(4096).astype(np.float32)
    d[:, :16] = -0.0                     # every d_j a negative zero ...
    g[:8] = -0.0                         # ... with g = -0.0 and with g > 0
    # NaNs of different payloads in several workers, in g and in both
    for j in range(n):
        d[j, 16 + j] = _f32(0x7FC00010 + j)
        d[j, 40] = _f32(0xFF800020 + j)  # signalling, every worker
    g[16] = _f32(0x7FC00AAA)
    g[41] = _f32(0xFFC00BBB)
    d[0, 42], d[-1, 42] = np.inf, -np.inf   # inf - inf in the sum
    d[0, 43] = np.inf
    g[43] = -np.inf                          # inf - inf in the add
    return g, d


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7])
def test_fold_f32_mean_arm_equals_jnp_mean(n):
    """``g + jnp.mean(d, 0)`` as XLA compiles it: the sum from +0.0 (d_0
    alone for one worker), times fl(1/n) fused with the add; bit for bit,
    3, 5 and 7 workers (no power of two) too."""
    g, d = _fold_inputs(n, n)
    np.testing.assert_array_equal(_bits(fold_f32_ref(_t(g), _t(d), n)),
                                  _bits(_jax_mean_fold(g, d)))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7])
def test_fold_f32_elastic_arm_equals_sum_over_count(n):
    g, d = _fold_inputs(n, 10 + n)
    for c in sorted({1, max(1, n - 1), n}):
        np.testing.assert_array_equal(
            _bits(fold_f32_ref(_t(g), _t(d), torch.tensor(float(c)))),
            _bits(_jax_elastic_fold(g, d, c)), err_msg=f"count {c}")


def test_fold_f32_in_place_and_the_wrappers_plain_path():
    g, d = _fold_inputs(3, 0)
    want = _bits(_jax_mean_fold(g, d))
    gt = _t(g.copy())
    assert nat.fold_f32(gt, _t(d), 3, out=gt) is gt
    np.testing.assert_array_equal(_bits(gt), want)


def test_the_old_torch_fold_differed_on_three_workers():
    """What this repairs: ``g + torch.mean(d, 0)`` (PyTorch's CPU mean
    divides) is not the reference's fused multiply-add."""
    rng = np.random.default_rng(5)
    d = rng.standard_normal((3, 4096)).astype(np.float32)
    g = rng.standard_normal(4096).astype(np.float32)
    old = _bits(_t(g) + torch.mean(_t(d), dim=0))
    want = _bits(_jax_mean_fold(g, d))
    assert np.mean(old != want) > 0.1
    np.testing.assert_array_equal(_bits(fold_f32_ref(_t(g), _t(d), 3)), want)


# ------------------------------------------------ one step, NaN payloads

def _pair(n, **kw):
    params, metas = _tiny_tree()
    cfg = dict(n_workers=n, beta=0.5, nonfinite_guard=False, **kw)
    jmetas = {k: JParamMeta(*m) for k, m in metas.items()}
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    jopt = JEF21Muon(JEF21MuonConfig(use_pallas=False, **cfg))
    topt = EF21Muon(EF21MuonConfig(**cfg))
    jstep = jax.jit(lambda st, c, t, s=jopt.make_step(jmetas): s(
        st, _grad_jax, c, t))
    tstep = topt.make_step(tmetas)
    jstate = dict(jopt.init(jax.random.key(0),
                            {k: jnp.asarray(v) for k, v in params.items()},
                            jmetas))
    return params, jstate, jstep, tstep


def _set(tree, key, where, bits):
    out = dict(tree)
    a = np.array(out[key])
    for idx, b in zip(where, bits):
        a.reshape(-1)[idx] = _f32(b)
    out[key] = jnp.asarray(a)
    return out


def _both_steps(params, jstate, jstep, tstep, c):
    tstate = state_from_jax(_np_tree(jstate))
    jout, _ = jstep(jstate, _jbatch(c), jnp.float32(0.04))
    tout, _ = tstep(tstate, _grad_torch, _tbatch(c), 0.04)
    return tout, jout


def _assert_bits(tout, jout, key):
    for k in jout[key]:
        np.testing.assert_array_equal(_bits(tout[key][k]),
                                      _bits(jout[key][k]),
                                      err_msg=f"{key}/{k}")


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("w2s", ["identity", "top10", "natural"])
@pytest.mark.parametrize("participation", ["full", "round_robin"])
def test_fold_in_a_step_keeps_the_references_nan_bits(n, w2s,
                                                      participation):
    """g_server carries NaN payloads and worker 0's (and worker n-1's)
    payload turns NaN at the same elements, from one NaN source each (so
    no other add meets two NaNs): the fold keeps the sum's NaN, as the
    reference's; with 3 workers the finite elements are the fused mean's
    too. Guard off, so the NaNs are folded."""
    part = "full" if participation == "full" else f"round_robin({n})"
    params, jstate, jstep, tstep = _pair(n, w2s=w2s, s2w="identity",
                                         participation=part)
    jstate["g_server"] = _set(_set(jstate["g_server"], "bias", (0, 1),
                                   (0x7FC00AAA, 0xFFC00AAA)),
                              "wq", (0, 5), (0x7FC00AAA, 0x7FC00CCC))
    c = _coeffs(params, 200, n)
    for k in ("bias", "wq"):
        c[k].reshape(n, -1)[0, 0] = _f32(0x7FC00BBB)
        c[k].reshape(n, -1)[n - 1, 1] = _f32(0xFFC00DDD)
    tout, jout = _both_steps(params, jstate, jstep, tstep, c)
    _assert_bits(tout, jout, "g_server")
    _assert_bits(tout, jout, "g_w")
    if w2s != "natural":
        # the sum's NaN, not g_server's
        assert _bits(tout["g_server"]["bias"])[0] != 0x7FC00AAA
        assert np.isnan(tout["g_server"]["bias"][0].item())


@pytest.mark.parametrize("w2s", ["identity", "top10"])
def test_ef21_round_keeps_the_references_nan_bits(w2s):
    """G_j and M_j NaN at one element of worker 0 (payloads of one sign,
    so the bf16 wire does not see which the difference kept): G_j +
    delta keeps G_j's payload for the lossless wire, the TopK delta's
    (0x7FC00000) over it, as the reference's."""
    params, jstate, jstep, tstep = _pair(2, w2s=w2s, s2w="identity")
    for k in ("bias", "wq"):
        jstate["g_w"] = _set(jstate["g_w"], k, (0,), (0x7FC00AAA,))
    c = _coeffs(params, 200)
    for k in ("bias", "wq"):
        c[k].reshape(2, -1)[0, 0] = _f32(0x7FC00BBB)
    tout, jout = _both_steps(params, jstate, jstep, tstep, c)
    _assert_bits(tout, jout, "g_w")
    got = _bits(tout["g_w"]["wq"]).reshape(2, -1)[0, 0]
    assert got == (0x7FC00AAA if w2s == "identity" else 0x7FC00000)


@pytest.mark.parametrize("s2w", ["top10", "natural"])
@pytest.mark.parametrize("resync", [None, 2])
def test_s2w_leg_and_replay_keep_the_references_nan_bits(s2w, resync):
    """W (and every W_j) NaN where X is finite, and X NaN where W is
    finite: W + delta and the replay's W_j + delta keep the reference's
    payload (a TopK delta's before W's)."""
    params, jstate, jstep, tstep = _pair(2, w2s="top10", s2w=s2w,
                                         resync=resync)
    for k in ("bias", "wq"):
        jstate["w"] = _set(jstate["w"], k, (0, 2), (0x7FC00AAA, 0xFFC00111))
        jstate["x"] = _set(jstate["x"], k, (1,), (0x7FC00EEE,))
    if resync:
        jstate["w_w"] = {k: jnp.broadcast_to(v, jstate["w_w"][k].shape)
                         for k, v in jstate["w"].items()}
    tout, jout = _both_steps(params, jstate, jstep, tstep,
                             _coeffs(params, 200))
    _assert_bits(tout, jout, "w")
    if resync:
        _assert_bits(tout, jout, "w_w")
