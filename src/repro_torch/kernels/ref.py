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
