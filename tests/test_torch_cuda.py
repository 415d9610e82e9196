"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips without a card (the kernels have no CPU
mode). This file imports neither JAX nor the reference package, so it
also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_cuda.py

``python3 chip_smoke.py`` runs the same checks at nanogpt's full-width
shapes. Tolerances are max|kernel - plain| / max|plain|: both sides are
f32 with f32 accumulation and differ only in summation order.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.newton_schulz import (LAUNCHES, fused_matmul,
                                               ns_iteration, reset_launches)

pytestmark = pytest.mark.cuda

ONE_PASS = 1e-5     # one GEMM / one NS iteration
NS_CHAIN = 1e-4     # 5 chained NS iterations


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(shape, seed, dev, normalise=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if normalise:
        x /= np.sqrt(np.sum(x * x, axis=(-2, -1), keepdims=True))
    return torch.from_numpy(x).to(dev)


def _rel(got, want):
    torch.cuda.synchronize()
    return ((got - want).abs().max() / want.abs().max()).item()


def test_ns_iteration_and_its_launches(dev):
    x = _t((3, 200, 328), 0, dev, normalise=True)
    reset_launches()
    got = ns_iteration(x)
    assert LAUNCHES == {"ns_iteration": 1, "fused_matmul": 2}
    assert _rel(got, ref.ns_iteration_batched_ref(x)) <= ONE_PASS


@pytest.mark.parametrize("trans_b,with_c", [(False, False), (True, True),
                                            (True, False), (False, True)])
def test_fused_matmul_ragged(dev, trans_b, with_c):
    a = _t((2, 130, 77), 1, dev)
    b = _t((2, 259, 77) if trans_b else (2, 77, 259), 2, dev)
    c = _t((2, 130, 259), 3, dev) if with_c else None
    got = fused_matmul(a, b, c, alpha=0.7, beta=-1.3, trans_b=trans_b)
    want = ref.fused_matmul_ref(a, b.mT if trans_b else b, c, 0.7, -1.3)
    assert _rel(got, want) <= ONE_PASS


@pytest.mark.parametrize("chunked", [False, True])
def test_newton_schulz_paths(dev, chunked, monkeypatch):
    """Whole stacks, and one slice per ns_iteration (a one-byte workspace
    budget): 5 iterations x 3 launches per chunk."""
    if chunked:
        monkeypatch.setattr(ops, "NS_WORKSPACE_BUDGET", 1)
    g = _t((2, 128, 384), 4, dev)
    reset_launches()
    assert _rel(ops.newton_schulz_batched(g),
                ref.newton_schulz_batched_ref(g)) <= NS_CHAIN
    chunks = 2 if chunked else 1
    assert LAUNCHES == {"ns_iteration": 5 * chunks,
                        "fused_matmul": 10 * chunks}
    g2 = _t((300, 130), 5, dev)
    assert _rel(ops.newton_schulz(g2),
                ref.newton_schulz_ref(g2)) <= NS_CHAIN


def test_wrappers_raise_instead_of_falling_back(dev):
    x = _t((2, 64, 96), 6, dev)
    with pytest.raises(TypeError, match="float32"):
        ns_iteration(x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        ns_iteration(x.mT)
    with pytest.raises(ValueError, match="on cpu"):
        fused_matmul(x, x.cpu(), trans_b=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_matmul(x, x)
