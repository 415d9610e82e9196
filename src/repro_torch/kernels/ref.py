"""Plain PyTorch versions of the Newton-Schulz and Natural kernels.

Port of ``repro/kernels/ref.py`` (the Newton-Schulz and Natural parts).
These are the semantic ground truth of the port's CUDA kernels: the
kernel wrappers in ``newton_schulz.py`` and ``natural_pack.py`` run them
for tensors on the CPU, and the tests and ``chip_smoke.py`` hold the
kernels against them on the card.

Every product here is meant as a true f32 product, to match the
reference's f32 LMO. On the card that needs TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default);
these functions leave the setting to their caller.
"""
from __future__ import annotations

import torch

# Jordan et al. (2024) quintic Newton-Schulz coefficients.
NS_COEFFS = (3.4445, -4.7750, 2.0315)


def fused_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor | None, alpha: float = 1.0,
                     beta: float = 1.0) -> torch.Tensor:
    """out = alpha * c + beta * (a @ b), f32, batched over leading dims."""
    out = beta * (a.to(torch.float32) @ b.to(torch.float32))
    if c is not None:
        out = out + alpha * c.to(torch.float32)
    return out


def syrk_upper_ref(x: torch.Tensor, c: torch.Tensor | None = None,
                   alpha: float = 1.0, beta: float = 1.0) -> torch.Tensor:
    """out = beta * (x @ x^T) + alpha * c on the upper triangle, mirrored
    below it, f32, batched over leading dims: exactly symmetric, and equal
    to the formula when c is symmetric (c's lower triangle is not read)."""
    xf = x.to(torch.float32)
    out = beta * (xf @ xf.transpose(-1, -2))
    if c is not None:
        out = out + alpha * c.to(torch.float32)
    return torch.triu(out) + torch.triu(out, 1).transpose(-1, -2)


def ns_iteration_ref(x: torch.Tensor, coeffs=NS_COEFFS) -> torch.Tensor:
    """One quintic Newton-Schulz iteration: X' = aX + (bA + cA^2) X,
    A = XX^T."""
    a, b, c = coeffs
    xf = x.to(torch.float32)
    gram = xf @ xf.T
    poly = b * gram + c * (gram @ gram)
    return (a * xf + poly @ xf).to(x.dtype)


def newton_schulz_ref(g: torch.Tensor, steps: int = 5, coeffs=NS_COEFFS,
                      eps: float = 1e-7) -> torch.Tensor:
    """Approximate UV^T of the SVD of g; iterates on the transpose when
    rows > cols so the gram is built on the small side."""
    if g.ndim != 2:
        raise ValueError("newton_schulz_ref expects a 2-D matrix")
    transpose = g.shape[0] > g.shape[1]
    x = g.T if transpose else g
    x = x / (torch.linalg.norm(x.to(torch.float32)) + eps).to(x.dtype)
    for _ in range(steps):
        x = ns_iteration_ref(x, coeffs)
    return x.T if transpose else x


def ns_iteration_batched_ref(x: torch.Tensor,
                             coeffs=NS_COEFFS) -> torch.Tensor:
    """Batched quintic NS iteration over a [B, m, n] slice stack."""
    a, b, c = coeffs
    xf = x.to(torch.float32)
    gram = xf @ xf.transpose(-1, -2)
    poly = b * gram + c * (gram @ gram)
    return (a * xf + poly @ xf).to(x.dtype)


def newton_schulz_batched_ref(g: torch.Tensor, steps: int = 5,
                              coeffs=NS_COEFFS,
                              eps: float = 1e-7) -> torch.Tensor:
    """Batched orthogonalisation over [B, m, n] stacks (m <= n; the
    bucketing layer canonicalises orientation). Per-slice f32 Frobenius
    normalisation."""
    if g.ndim != 3:
        raise ValueError("newton_schulz_batched_ref expects [B, m, n]")
    nrm = torch.sqrt(torch.sum(torch.square(g.to(torch.float32)),
                               dim=(-2, -1), keepdim=True))
    x = g / (nrm + eps).to(g.dtype)
    for _ in range(steps):
        x = ns_iteration_batched_ref(x, coeffs)
    return x


def to_bf16_ref(x: torch.Tensor) -> torch.Tensor:
    """f32 or bf16 -> bf16 with XLA's bits: round to nearest even, as
    ``x.to(torch.bfloat16)`` rounds every value that is not a NaN, and
    every NaN -> ``sign | 0x7FC0`` (PyTorch's CPU cast gives 0xFFFF or
    0x7FC0, its CUDA cast its own NaN). bf16 passes through."""
    if x.dtype == torch.bfloat16:
        return x
    if x.dtype != torch.float32:
        raise TypeError(f"to_bf16 takes torch.float32 or torch.bfloat16, "
                        f"got {x.dtype}")
    y = x.to(torch.bfloat16).view(torch.int16)
    # 0xFFC0 (the int16 -64) for a NaN whose sign bit is set, else 0x7FC0
    nan_bits = torch.where(torch.signbit(x), -64, 0x7FC0).to(torch.int16)
    return torch.where(torch.isnan(x), nan_bits, y).view(torch.bfloat16)


def natural_compress_ref(x: torch.Tensor) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Deterministic natural compression: cast to bf16 (round to nearest
    even, NaN to ``sign | 0x7FC0``: ``to_bf16_ref``), round to the nearest
    power of two. Returns (exponent code uint8, sign uint8 in {0,1}), both
    of ``x``'s shape.

    bf16 is 1 sign | 8 exponent | 7 mantissa bits; rounding to the
    nearest power of two adds one to the exponent when the top mantissa
    bit is set. Zero maps to code 0; inf and NaN clamp to code 254.
    PyTorch has little uint16 arithmetic, so the bits are the int16 view
    widened to int32 and masked."""
    bits = to_bf16_ref(x).view(torch.int16).to(torch.int32) & 0xFFFF
    sign = (bits >> 15).to(torch.uint8)
    rounded = torch.clamp(((bits >> 7) & 0xFF) + ((bits >> 6) & 1), max=254)
    code = torch.where((bits & 0x7FFF) == 0, 0, rounded).to(torch.uint8)
    return code, sign


def natural_decompress_ref(code: torch.Tensor,
                           sign: torch.Tensor) -> torch.Tensor:
    """Inverse of natural_compress_ref -> bf16 powers of two (code 0 is
    a signed zero)."""
    # sign * -2^15 + code << 7 is the int16 value of the bf16 bits
    bits = (code.to(torch.int32) << 7) - (sign.to(torch.int32) << 15)
    return bits.to(torch.int16).view(torch.bfloat16)


# ------------------------------------------------ f32 adds with XLA's NaNs

_QUIET = 0x00400000
_DEFAULT_NAN = -4194304     # 0xFFC00000 as int32: the x86 default NaN,
                            # XLA's CPU result of an invalid operation


def _nan_pick(first: torch.Tensor, second: torch.Tensor,
              result: torch.Tensor) -> torch.Tensor:
    """``result`` (f32) with XLA's NaN bits on the CPU: ``first`` quieted
    where it is a NaN, else ``second`` quieted where it is one, else
    ``result``, whose own NaNs (an invalid operation, inf - inf) become
    ``0xFFC00000``. The operands broadcast against ``result``."""
    a, b = first.view(torch.int32), second.view(torch.int32)
    r = result.view(torch.int32)
    r = torch.where(torch.isnan(result), _DEFAULT_NAN, r)
    r = torch.where(torch.isnan(second), b | _QUIET, r)
    return torch.where(torch.isnan(first), a | _QUIET, r).view(torch.float32)


def add_f32_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` in f32 with XLA's NaN rule: ``a``'s NaN quieted (``|
    0x00400000``), else ``b``'s, else the IEEE sum (``_nan_pick``)."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    return _nan_pick(a, b, a + b)


def _fma_f32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of f32 tensors and an f32 value ``b``, rounded once,
    as a fused multiply-add (non-finite results aside). The product is
    exact in float64; the sum
    is rounded to odd there (TwoSum gives its error, and an inexact sum
    with an even last bit moves one unit toward the exact value), so the
    final rounding to f32 is the only one that counts."""
    p = a.to(torch.float64) * b
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    bits = torch.where(fix, bits + torch.where((err > 0) == (s > 0), 1, -1),
                       bits)
    return bits.view(torch.float64).to(torch.float32)


def fold_f32_ref(g: torch.Tensor, d: torch.Tensor,
                 count: int | torch.Tensor) -> torch.Tensor:
    """The server's fold ``g + (sum_j d_j) / count`` over the worker lead
    of ``d`` (``[n, *g.shape]``), in f32 with XLA's NaN rule at every
    operation (the reference's compiled fold on the CPU):

      * the sum runs j = 0, 1, ... from +0.0 (one worker: ``d_0`` itself,
        XLA drops a reduction over one element);
      * ``count`` an int n is ``jnp.mean``: XLA multiplies by the f32
        reciprocal of n, fused with the add into one rounding
        (``fma(s, 1/n, g)``; one worker: ``g + d_0``, g's NaN first);
        ``count`` a tensor (the elastic arm's dynamic count) divides,
        then adds;
      * the sum's or quotient's NaN comes first, then ``g``'s."""
    g, d = g.to(torch.float32), d.to(torch.float32)
    s = d[0]
    if d.shape[0] > 1:
        s = add_f32_ref(torch.zeros_like(s), s)
        for j in range(1, d.shape[0]):
            s = add_f32_ref(s, d[j])
    if isinstance(count, torch.Tensor):
        c = count.to(torch.float32)
        q = _nan_pick(s, c, s / c)
        return _nan_pick(q, g, q + g)
    if d.shape[0] == 1:
        # XLA drops the product by 1.0 too: a plain add, g's NaN first
        return add_f32_ref(g, s)
    recip = float(torch.tensor(1.0, dtype=torch.float32) / int(count))
    return _nan_pick(s, g, _fma_f32(s, recip, g))
