"""EF21 (w2s) and EF21-P (s2w) error-feedback algebra (§2, §A.2).

Port of ``repro/core/error_feedback.py``. Both mechanisms share one
primitive: keep an estimate E of a target T, send C(T - E), and advance
E by the exact decompressed message, so sender and receiver stay
bit-identical:

    payload = C(T - E);   E' = E + decompress(payload)

The wire dtype is bf16 and the cast is inside C, so the quantisation
error is part of the compression error the feedback loop corrects —
except for lossless compressors, which carry the exact f32 difference.
Every f32 -> bf16 cast here goes through ``cast``, which keeps XLA's bits
(a NaN becomes ``sign | 0x7FC0``), so a NaN reaches the wire and the
estimates with the reference's bits. Tensors are
``[*lead, *slice_shape]``: every leading index is its own message.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.natural_pack import to_bf16


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)``, except that an f32 -> bf16 cast keeps XLA's bits
    (``to_bf16``: round to nearest even, every NaN to ``sign | 0x7FC0``),
    as the reference's ``astype`` does."""
    if dtype == torch.bfloat16 and x.dtype == torch.float32:
        return to_bf16(x)
    return x.to(dtype)


def ef_compress_step(comp, comp_state: Any, estimate: torch.Tensor,
                     target: torch.Tensor, slice_shape: tuple[int, ...],
                     wire_dtype: torch.dtype = torch.bfloat16):
    """One error-feedback round. Returns (payload, new_comp_state,
    new_estimate) with new_estimate = estimate + decompress(payload) in
    f32, cast back to the estimate's dtype."""
    diff = target.to(torch.float32) - estimate.to(torch.float32)
    if getattr(comp, "lossless_wire", False):
        wire_dtype = torch.float32
    payload, comp_state = comp.compress(comp_state, cast(diff, wire_dtype),
                                        slice_shape)
    delta = comp.decompress(payload, diff.shape, torch.float32)
    new_estimate = cast(estimate.to(torch.float32) + delta, estimate.dtype)
    return payload, comp_state, new_estimate


def apply_payload(comp, payload, estimate: torch.Tensor) -> torch.Tensor:
    """Receiver side: E' = E + decompress(payload)."""
    delta = comp.decompress(payload, estimate.shape, torch.float32)
    return cast(estimate.to(torch.float32) + delta, estimate.dtype)
