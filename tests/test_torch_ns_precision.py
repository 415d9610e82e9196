"""The accuracy argument for the Newton-Schulz kernels' 3xTF32 products,
run on the CPU by emulating the tensor core's arithmetic in torch.

The CUDA kernels (``repro_torch/kernels/csrc/newton_schulz.cu``) compute
every f32 product on TF32 tensor cores: each operand v is split into
``hi = tf32_rn(v)`` and ``lo = tf32_rn(v - hi)`` (TF32 keeps 10 of f32's
23 mantissa bits; ``cvt.rna`` rounds to nearest, ties away from zero), and
a product is ``lo*hi + hi*lo + hi*hi``. Each MMA sums its k = 8 products
into the accumulator and, as measured on earlier NVIDIA tensor cores
(Fasi, Higham, Mikaitis and Pranesh, 2021), truncates that sum rather
than rounding it to nearest. So the kernel sums each 64-deep span of K
into a fresh tile and adds the span to the running sum in ordinary f32
("promotion").

Emulated here with bit masks and float64: products of TF32 values are
exact in float64, and a truncated MMA sum is the float64 sum rounded
toward zero to f32. The tolerance is the one the card's checks hold the
kernels to (``chip_smoke.py``'s ``TOL_ONE_PASS``), as max|got - exact| /
max|exact| at nanogpt's longest K, 3072.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

TOL_ONE_PASS = 1e-5   # chip_smoke.py: one GEMM / one NS iteration
K = 3072              # the [24, 768, 3072] bucket's gram
PROMOTE = 64          # the kernel's promotion span (PROMOTE x BK)


def tf32_rn(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (the low 13 mantissa bits zero), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: add half of the dropped
    range to the magnitude bits and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rn(x)
    return hi, tf32_rn(x - hi)


def three_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` from the three TF32 products, summed exactly (float64)."""
    (ah, al), (bh, bl) = split(a), split(b)
    d = torch.float64
    return (al.to(d) @ bh.to(d) + ah.to(d) @ bl.to(d)
            + ah.to(d) @ bh.to(d))


def one_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One-pass TF32: the hi parts only, summed exactly."""
    return tf32_rn(a).double() @ tf32_rn(b).double()


def _toward_zero(s: torch.Tensor) -> torch.Tensor:
    """float64 -> f32, rounded toward zero."""
    f = s.float()
    over = f.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mma_chain(a: torch.Tensor, b: torch.Tensor, promote: int) -> torch.Tensor:
    """``a @ b`` as the kernel's MMAs compute it: per k-step of 8, three
    MMAs (small terms first), each summing the accumulator and its 8
    exact products and truncating to f32. ``promote``: the depth after
    which the slice's sum is added to the running f32 sum (0: never)."""
    (ah, al), (bh, bl) = split(a), split(b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    part = torch.zeros_like(acc)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            part = _toward_zero(part.double()
                                + x[:, ks].double() @ y[ks].double())
        if promote and (k0 + 8) % promote == 0:
            acc = acc + part
            part = torch.zeros_like(acc)
    return acc + part


def _inputs(kind: str, product: str):
    """``a [48, K] @ b [K, 48]``: a gram (``b = a^T``, positive diagonal
    sums, where truncation drifts most) or a general product; entries
    unit-normal, or spanning ~2^20 (a random power of two in [2^-10,
    2^10] per entry)."""
    rng = np.random.default_rng(0)

    def draw():
        x = rng.standard_normal((48, K))
        if kind == "wide":
            x = x * np.exp2(rng.integers(-10, 11, size=x.shape))
        return torch.from_numpy(x.astype(np.float32))

    a = draw()
    b = a.T.contiguous() if product == "gram" else draw().T.contiguous()
    return a, b


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def test_tf32_rounding():
    x = torch.tensor([1 + 2**-11, 1 + 2**-12, 1 + 3 * 2**-11, -(1 + 2**-11),
                      3.0, 1e-30], dtype=torch.float32)
    want = torch.tensor([1 + 2**-10, 1.0, 1 + 2**-9, -(1 + 2**-10), 3.0,
                         1e-30], dtype=torch.float32)
    got = tf32_rn(x)
    assert torch.equal(got[:5], want[:5])
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    hi, lo = split(torch.randn(1000))
    assert (lo.abs() <= hi.abs() * 2**-11).all()


@pytest.mark.parametrize("kind", ["normal", "wide"])
@pytest.mark.parametrize("product", ["gram", "general"])
def test_three_tf32_is_f32_accurate_and_one_pass_is_not(kind, product):
    """Summed exactly, 3xTF32 lands ~100x inside the one-pass tolerance
    at K = 3072 (held to 20x); one-pass TF32 misses it."""
    a, b = _inputs(kind, product)
    want = a.double() @ b.double()
    assert _rel(three_tf32(a, b), want) <= TOL_ONE_PASS / 20
    assert _rel(one_tf32(a, b), want) > TOL_ONE_PASS


@pytest.mark.parametrize("kind", ["normal", "wide"])
def test_truncating_mma_sums_need_promotion(kind):
    """With the MMAs' truncated sums carried through all 1152 MMAs of a
    K = 3072 gram, the diagonal (all terms positive) drifts past the
    tolerance; promoting each 64-deep span keeps it >10x inside."""
    a, b = _inputs(kind, "gram")
    want = a.double() @ b.double()
    assert _rel(mma_chain(a, b, promote=0), want) > TOL_ONE_PASS
    assert _rel(mma_chain(a, b, promote=PROMOTE), want) <= TOL_ONE_PASS / 10
