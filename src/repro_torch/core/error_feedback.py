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


def ef_compress(comp, comp_state: Any, estimate: torch.Tensor,
                target: torch.Tensor, slice_shape: tuple[int, ...],
                wire_dtype: torch.dtype = torch.bfloat16):
    """The sender's half of a round: (payload, new_comp_state) with
    payload = C(T - E), the f32 difference cast to the wire dtype (kept
    f32 for lossless compressors). A sender that advances E from the
    wire bytes, as the packed EF21-P leg does, calls only this."""
    # contiguous whatever the operands' layouts (a server iterate's leaf
    # may be a transposed view): the cast's kernel reads it as rows
    diff = torch.empty(target.shape, dtype=torch.float32,
                       device=target.device)
    torch.sub(target.to(torch.float32), estimate.to(torch.float32), out=diff)
    if getattr(comp, "lossless_wire", False):
        wire_dtype = torch.float32
    return comp.compress(comp_state, cast(diff, wire_dtype), slice_shape)


def ef_compress_step(comp, comp_state: Any, estimate: torch.Tensor,
                     target: torch.Tensor, slice_shape: tuple[int, ...],
                     wire_dtype: torch.dtype = torch.bfloat16,
                     inplace: bool = False):
    """One error-feedback round. Returns (payload, new_comp_state,
    new_estimate) with new_estimate = estimate + decompress(payload) in
    f32, cast back to the estimate's dtype (written into ``estimate``
    itself with ``inplace``)."""
    payload, comp_state = ef_compress(comp, comp_state, estimate, target,
                                      slice_shape, wire_dtype)
    return payload, comp_state, apply_payload(comp, payload, estimate,
                                              inplace)


def apply_payload(comp, payload, estimate: torch.Tensor,
                  inplace: bool = False) -> torch.Tensor:
    """Receiver side: E' = E + decompress(payload). With ``inplace`` E'
    is written into ``estimate`` and returned: the same f32 add and
    cast, so the same bits."""
    delta = comp.decompress(payload, estimate.shape, torch.float32)
    if inplace and estimate.dtype == torch.float32:
        return estimate.add_(delta)
    new = cast(estimate.to(torch.float32) + delta, estimate.dtype)
    return estimate.copy_(new) if inplace else new
