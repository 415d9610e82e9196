"""EF21 (w2s) and EF21-P (s2w) error-feedback algebra (§2, §A.2).

Port of ``repro/core/error_feedback.py``. Both mechanisms share one
primitive: keep an estimate E of a target T, send C(T - E), and advance
E by the exact decompressed message, so sender and receiver stay
bit-identical:

    payload = C(T - E);   E' = E + decompress(payload)

The wire dtype is bf16 and the cast is inside C, so the quantisation
error is part of the compression error the feedback loop corrects —
except for lossless compressors, which carry the exact f32 difference.
Tensors are ``[*lead, *slice_shape]``: every leading index is its own
message.
"""
from __future__ import annotations

from typing import Any

import torch


def ef_compress_step(comp, comp_state: Any, estimate: torch.Tensor,
                     target: torch.Tensor, slice_shape: tuple[int, ...],
                     wire_dtype: torch.dtype = torch.bfloat16):
    """One error-feedback round. Returns (payload, new_comp_state,
    new_estimate) with new_estimate = estimate + decompress(payload) in
    f32, cast back to the estimate's dtype."""
    diff = target.to(torch.float32) - estimate.to(torch.float32)
    if getattr(comp, "lossless_wire", False):
        wire_dtype = torch.float32
    payload, comp_state = comp.compress(comp_state, diff.to(wire_dtype),
                                        slice_shape)
    delta = comp.decompress(payload, diff.shape, torch.float32)
    new_estimate = (estimate.to(torch.float32) + delta).to(estimate.dtype)
    return payload, comp_state, new_estimate


def apply_payload(comp, payload, estimate: torch.Tensor) -> torch.Tensor:
    """Receiver side: E' = E + decompress(payload)."""
    delta = comp.decompress(payload, estimate.shape, torch.float32)
    return (estimate.to(torch.float32) + delta).to(estimate.dtype)
