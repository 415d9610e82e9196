"""Parity of the port's Newton-Schulz kernels with the reference's.

On the CPU the port's kernel wrappers run their plain PyTorch versions
(``repro_torch/kernels/ref.py``); the reference's Pallas kernels run in
interpret mode, or through ``repro.kernels.ref``, as
``tests/test_kernels.py`` runs them. Inputs come from numpy and go
through both. The CUDA kernels themselves need the card: their tests
are in ``tests/test_torch_cuda.py``.

Tolerances: both sides compute in f32 and differ only in summation order
(XLA's CPU dot vs PyTorch's), so one GEMM or one iteration agrees to a
few f32 ulps of its output scale; five chained NS iterations amplify
that by the polynomial's coefficients (|a|+|b|+|c| ~ 10 per iteration).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref
from repro.kernels.newton_schulz import fused_matmul as jfused_matmul
from repro.kernels.newton_schulz import ns_iteration_fused
from repro.kernels.ops import newton_schulz as jnewton_schulz
from repro.kernels.ops import newton_schulz_batched as jnewton_schulz_batched
from repro_torch.kernels import ops, ref
from repro_torch.kernels.newton_schulz import (LAUNCHES, fused_matmul,
                                               ns_iteration, reset_launches,
                                               syrk_upper)

# max|port - reference| / max|reference|
ONE_PASS = 4e-6     # one GEMM / one NS iteration: ~32 f32 ulps of the scale
NS_CHAIN = 1e-5     # up to 5 chained NS iterations


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= tol, f"rel err {err:.3g} > {tol:g}"


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _normalised(shape, seed):
    x = _np(shape, seed)
    return x / np.sqrt(np.sum(x * x, axis=(-2, -1), keepdims=True))


@pytest.mark.parametrize("m,k,n,has_c,trans_b", [
    (128, 256, 128, True, False),
    (256, 128, 384, False, False),
    (128, 384, 256, True, True),
])
def test_fused_matmul_matches_pallas(m, k, n, has_c, trans_b):
    """fused_matmul (plain on the CPU) == the Pallas kernel (interpret)."""
    a = _np((m, k), 0)
    b = _np((n, k) if trans_b else (k, n), 1)
    c = _np((m, n), 2) if has_c else None
    want = jfused_matmul(jnp.asarray(a), jnp.asarray(b.T if trans_b else b),
                         None if c is None else jnp.asarray(c), alpha=0.7,
                         beta=-1.3, out_dtype=jnp.float32, interpret=True)
    got = fused_matmul(torch.from_numpy(a), torch.from_numpy(b),
                       None if c is None else torch.from_numpy(c),
                       alpha=0.7, beta=-1.3, trans_b=trans_b)
    _close(got.numpy(), np.asarray(want), ONE_PASS)


def test_fused_matmul_batched_ragged_matches_ref():
    """Ragged batched shapes (the CUDA kernel masks its edges) against
    the reference's oracle slice by slice."""
    a, b, c = _np((3, 130, 77), 0), _np((3, 259, 77), 1), _np((3, 130, 259), 2)
    got = fused_matmul(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c), alpha=2.0, beta=0.5, trans_b=True)
    for i in range(3):
        want = jref.fused_matmul_ref(jnp.asarray(a[i]), jnp.asarray(b[i].T),
                                     jnp.asarray(c[i]), 2.0, 0.5)
        _close(got[i].numpy(), np.asarray(want), ONE_PASS)


@pytest.mark.parametrize("m,k,has_c", [(128, 256, True), (256, 128, False),
                                       (256, 384, True)])
def test_syrk_upper_matches_pallas(m, k, has_c):
    """syrk_upper (plain on the CPU), ``beta * x @ x^T + alpha * c`` on the
    upper triangle and mirrored, == the Pallas fused_matmul (interpret) of
    x against its transpose, with a symmetric c; exactly symmetric."""
    x = _np((m, k), 0)
    c = _np((m, m), 1) if has_c else None
    if has_c:
        c = c + c.T
    want = jfused_matmul(jnp.asarray(x), jnp.asarray(x.T),
                         None if c is None else jnp.asarray(c), alpha=0.7,
                         beta=-1.3, out_dtype=jnp.float32, interpret=True)
    got = syrk_upper(torch.from_numpy(x),
                     None if c is None else torch.from_numpy(c), alpha=0.7,
                     beta=-1.3)
    _close(got.numpy(), np.asarray(want), ONE_PASS)
    assert torch.equal(got, got.mT)


def test_syrk_upper_reads_the_upper_triangle_only():
    """A non-symmetric c: the result takes c's upper triangle and mirrors
    it, batched and ragged."""
    x, c = _np((3, 130, 77), 2), _np((3, 130, 130), 3)
    got = syrk_upper(torch.from_numpy(x), torch.from_numpy(c), alpha=2.0,
                     beta=0.5)
    c_up = np.triu(c) + np.swapaxes(np.triu(c, 1), -1, -2)
    for i in range(3):
        want = jref.fused_matmul_ref(jnp.asarray(x[i]), jnp.asarray(x[i].T),
                                     jnp.asarray(c_up[i]), 2.0, 0.5)
        _close(got[i].numpy(), np.asarray(want), ONE_PASS)
    assert torch.equal(got, got.mT)


@pytest.mark.parametrize("bsz,m,n", [(2, 128, 256), (3, 200, 328)])
def test_ns_iteration_as_its_three_kernels(bsz, m, n):
    """The card's three launches, in their plain versions: the gram and
    the poly ``c G G^T + b G`` on the symmetric kernel (G is exactly
    symmetric, so G G^T = G G), the update on fused_matmul, == the
    reference's NS iteration."""
    x = _normalised((bsz, m, n), 9)
    a, b, c = ref.NS_COEFFS
    xt = torch.from_numpy(x)
    gram = ref.syrk_upper_ref(xt)
    poly = ref.syrk_upper_ref(gram, gram, b, c)
    got = ref.fused_matmul_ref(poly, xt, xt, a, 1.0)
    want = jref.ns_iteration_batched_ref(jnp.asarray(x), jref.NS_COEFFS)
    _close(got.numpy(), np.asarray(want), ONE_PASS)


@pytest.mark.parametrize("bsz,m,n", [(2, 128, 256), (1, 256, 256)])
def test_ns_iteration_matches_pallas(bsz, m, n):
    """ns_iteration (plain on the CPU) == the fused Pallas NS iteration
    (interpret)."""
    x = _normalised((bsz, m, n), 3)
    want = ns_iteration_fused(jnp.asarray(x), jref.NS_COEFFS, interpret=True)
    got = ns_iteration(torch.from_numpy(x))
    _close(got.numpy(), np.asarray(want), ONE_PASS)


@pytest.mark.parametrize("shape", [(48, 32), (32, 80), (80, 32), (200, 328),
                                   (130, 70)])
@pytest.mark.parametrize("chunked", [False, True])
def test_newton_schulz_matches_reference(shape, chunked, monkeypatch):
    """2-D newton_schulz incl. m > n (transposed) and shapes off the
    tile, with the default workspace budget and a budget of one byte."""
    if chunked:
        monkeypatch.setattr(ops, "NS_WORKSPACE_BUDGET", 1)
    g = _np(shape, 4)
    want = jnewton_schulz(jnp.asarray(g), steps=5, use_pallas=False)
    got = ops.newton_schulz(torch.from_numpy(g), steps=5)
    assert got.shape == shape
    _close(got.numpy(), np.asarray(want), NS_CHAIN)


def test_newton_schulz_matches_pallas_padded_path():
    """The reference's padded Pallas path (interpret) on a shape off the
    128 tile."""
    g = _np((136, 200), 5)
    want = jnewton_schulz(jnp.asarray(g), steps=3, use_pallas=True,
                          interpret=True)
    got = ops.newton_schulz(torch.from_numpy(g), steps=3)
    _close(got.numpy(), np.asarray(want), NS_CHAIN)


@pytest.mark.parametrize("bsz,m,n", [(3, 40, 72), (2, 128, 256),
                                     (4, 96, 96)])
@pytest.mark.parametrize("chunked", [False, True])
def test_newton_schulz_batched_matches_reference(bsz, m, n, chunked,
                                                 monkeypatch):
    """Whole stacks, and stacks run one slice per ns_iteration (a budget
    of one byte forces chunks of one)."""
    if chunked:
        monkeypatch.setattr(ops, "NS_WORKSPACE_BUDGET", 1)
    g = _np((bsz, m, n), 6)
    want = jnewton_schulz_batched(jnp.asarray(g), steps=5, use_pallas=False)
    got = ops.newton_schulz_batched(torch.from_numpy(g), steps=5)
    _close(got.numpy(), np.asarray(want), NS_CHAIN)


def test_zero_padding_is_exact():
    """Padding to the kernels' tile changes nothing: the padded path on
    the CPU equals the plain unpadded chain bit for bit."""
    g = torch.from_numpy(_np((3, 40, 72), 7))
    assert torch.equal(ops.newton_schulz_batched(g, steps=3),
                       ref.newton_schulz_batched_ref(g, steps=3))
    g2 = torch.from_numpy(_np((72, 40), 7))          # m > n: transposed
    _close(ops.newton_schulz(g2, steps=3).numpy(),
           ref.newton_schulz_ref(g2, steps=3).numpy(), ONE_PASS)


def test_ns_workspace_gate(monkeypatch):
    """ns_iteration holds [B, m, m] gram + poly in device memory; the
    budget admits nanogpt's buckets whole and splits oversized stacks
    into chunks that fit."""
    assert ops.ns_batch_chunk(48, 768) == 48    # 226 MB
    assert ops.ns_batch_chunk(24, 768) == 24
    assert ops.ns_batch_chunk(4096, 1024) == 128   # 8 MiB a slice
    monkeypatch.setattr(ops, "NS_WORKSPACE_BUDGET", 100 << 20)
    assert ops.ns_batch_chunk(48, 768) == 22
    monkeypatch.setattr(ops, "NS_WORKSPACE_BUDGET", 1)
    assert ops.ns_batch_chunk(48, 768) == 1


def test_cpu_wrappers_take_plain_versions_and_launch_nothing():
    x = torch.from_numpy(_normalised((2, 40, 72), 8))
    reset_launches()
    assert torch.equal(ns_iteration(x), ref.ns_iteration_batched_ref(x))
    a, b = torch.from_numpy(_np((5, 7), 0)), torch.from_numpy(_np((7, 3), 1))
    assert torch.equal(fused_matmul(a, b), ref.fused_matmul_ref(a, b, None))
    assert torch.equal(syrk_upper(a, alpha=0.5), ref.syrk_upper_ref(a))
    assert LAUNCHES == {"ns_iteration": 0, "fused_matmul": 0}


def test_wrappers_refuse_other_devices():
    x = torch.empty((2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ns_iteration(x)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_matmul(x, x)
    with pytest.raises(ValueError, match="cpu or cuda"):
        syrk_upper(x)

