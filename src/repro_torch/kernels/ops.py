"""Newton-Schulz and Natural entry points over the kernel wrappers.

Port of ``repro/kernels/ops.py:62-223`` without its mesh/shard_map
parts. Both entry points normalise, pad each slice with zeros to the
kernels' tile (exact for NS: padded rows and columns stay zero through
X' = aX + (bA + cA^2)X), run ``steps`` iterations and slice back. Which
device runs them follows the tensor: the kernel wrappers take their
plain versions for CPU tensors and launch the CUDA kernels for CUDA
tensors.

Each iteration is one ``ns_iteration`` (upper-tile gram, then poly and
update, over a ``[B, m, m]`` gram + poly workspace). Two callers: the
spectral LMO (``core/lmo.py``) on the gradient's slices, and RankK
(``core/compressors.py``) on its transposed sketches ``[L, r, m]``. A stack whose
workspace would exceed ``NS_WORKSPACE_BUDGET`` runs in batch chunks that
fit; the slices are independent, so chunking changes no value.

``natural_compress`` / ``natural_decompress`` are Natural compression
over a batch of rows ``[*lead, n]``, one message per row: 8-bit exponent
codes plus a 1-bit sign bitmap, zero-padded to a whole byte *per row*
(9 bits per value on the wire), as the reference pads each slice.
``pack_bits`` packs the ragged sign rows itself, and ``natural_decode``
turns codes and packed signs into bf16 in one pass.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .bitpack import natural_decode, pack_bits
from .natural_pack import natural_encode
from .newton_schulz import TILE, ns_iteration, ns_workspace_bytes
from .ref import NS_COEFFS

# Device bytes one ns_iteration may take for its gram + poly workspace.
# nanogpt-124m's largest bucket, [48, 768, 768], takes 226 MB.
NS_WORKSPACE_BUDGET = 1 << 30


def ns_batch_chunk(bsz: int, m: int) -> int:
    """Slices of a ``[bsz, m, *]`` stack that one ``ns_iteration`` takes
    within ``NS_WORKSPACE_BUDGET`` (at least one)."""
    return max(1, min(bsz, NS_WORKSPACE_BUDGET // ns_workspace_bytes(1, m)))


def _iterate(x: torch.Tensor, steps: int, coeffs) -> torch.Tensor:
    """``steps`` NS iterations over a normalised ``[B, m, n]`` stack."""
    bsz, m, n = x.shape
    pm, pn = (-m) % TILE, (-n) % TILE
    if pm or pn:
        x = F.pad(x, (0, pn, 0, pm))
    parts = []
    for part in x.split(ns_batch_chunk(bsz, x.shape[1])):
        for _ in range(steps):
            part = ns_iteration(part, coeffs)
        parts.append(part)
    x = parts[0] if len(parts) == 1 else torch.cat(parts)
    return x[:, :m, :n]


def newton_schulz(g: torch.Tensor, steps: int = 5, coeffs=NS_COEFFS,
                  eps: float = 1e-7) -> torch.Tensor:
    """Orthogonalise a matrix ``g`` (approximate UV^T of its SVD),
    iterating on the transpose when rows > cols."""
    if g.ndim != 2:
        raise ValueError("newton_schulz expects 2-D input")
    transpose = g.shape[0] > g.shape[1]
    x = g.T if transpose else g
    x = x / (torch.linalg.norm(x.to(torch.float32)) + eps).to(x.dtype)
    x = _iterate(x.contiguous()[None], steps, coeffs)[0]
    return x.T if transpose else x


def newton_schulz_batched(g: torch.Tensor, steps: int = 5,
                          coeffs=NS_COEFFS, eps: float = 1e-7
                          ) -> torch.Tensor:
    """Orthogonalise a ``[B, m, n]`` stack of independent slices (m <= n:
    callers canonicalise orientation before stacking), with per-slice
    f32 Frobenius normalisation."""
    if g.ndim != 3:
        raise ValueError("newton_schulz_batched expects [B, m, n]")
    nrm = torch.sqrt(torch.sum(torch.square(g.to(torch.float32)),
                               dim=(-2, -1), keepdim=True))
    x = g / (nrm + eps).to(g.dtype)
    return _iterate(x.contiguous(), steps, coeffs)


def natural_compress(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Natural-compress ``[*lead, n]`` rows -> (codes uint8 ``[*lead, n]``,
    packed signs uint8 ``[*lead, ceil(n/8)]``)."""
    code, sign = natural_encode(x.contiguous())
    return code, pack_bits(sign)


def natural_decompress(code: torch.Tensor, packed_sign: torch.Tensor,
                       shape: tuple[int, ...],
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of ``natural_compress`` (bf16 powers of two), reshaped to
    ``shape`` and cast to ``dtype`` (no cast for bf16)."""
    return natural_decode(code, packed_sign).reshape(shape).to(dtype)
