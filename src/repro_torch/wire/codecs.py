"""Per-payload-leaf wire codecs (DESIGN.md §6).

Port of ``repro/wire/codecs.py``. A codec is a bit-exact pair
``pack(rows[, out]) -> uint8 [*lead, nbytes]`` / ``unpack(uint8 [*lead,
nbytes]) -> rows`` for one fixed-shape payload leaf, over a batch of rows
(one per worker and stack slice; the reference vmaps the same pair over
them). The wire layout hands both its column of a leaf's region of the
stage buffer, ``[n_workers, n_stack, nbytes]`` at any byte offset:
``pack`` writes into it and ``unpack`` reads it, neither copying it. Two
cover every compressor the port runs:

  RawCodec        any tensor, byte for byte (a dtype view): bf16 values,
                  Natural's uint8 code planes and packed sign bitmaps,
                  Identity's f32 differences, indices too wide to narrow.
  NarrowIntCodec  int32 indices whose domain fits 2 (uint16) or 3
                  (uint24) bytes — TopK's and ColumnTopK's indices — as
                  byte planes,
                  plane-major within each row (``kernels/bitpack.py``).

Codec choice (``leaf_codecs``) is static: it reads the compressor and
the payload's structure, never values. A payload is a tensor or a flat
dict of tensors; its leaves are ordered as ``jax.tree.flatten`` orders
them (dict keys sorted), so the bytes are the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core import compressors as C
from repro_torch.kernels.bitpack import (narrow_decode, narrow_encode,
                                         narrow_width)


def flatten_payload(payload: Any) -> tuple[tuple, list]:
    """(leaf names, leaf tensors) of a payload in ``jax.tree.flatten``
    order; a bare tensor has the one name ``None``."""
    if isinstance(payload, dict):
        names = tuple(sorted(payload))
        return names, [payload[n] for n in names]
    return (None,), [payload]


def unflatten_payload(names: tuple, leaves: list) -> Any:
    """Inverse of ``flatten_payload``."""
    if names == (None,):
        return leaves[0]
    return dict(zip(names, leaves, strict=True))


@dataclass(frozen=True)
class RawCodec:
    """Byte-for-byte view of one payload leaf."""
    shape: tuple[int, ...]          # per-row leaf shape
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    @property
    def cid(self) -> str:
        return "raw:" + str(self.dtype).removeprefix("torch.")

    def pack(self, x: torch.Tensor,
             out: torch.Tensor | None = None) -> torch.Tensor:
        """``[*lead, *shape]`` -> uint8 ``[*lead, nbytes]``: its bytes,
        copied into ``out`` (a uint8 view with as many rows) if given."""
        lead = x.shape[:x.ndim - len(self.shape)]
        assert tuple(x.shape[len(lead):]) == self.shape, (x.shape, self.shape)
        b = x.reshape(lead + (-1,)).view(torch.uint8)
        return b.contiguous() if out is None else out.copy_(
            b.reshape(out.shape))

    def unpack(self, b: torch.Tensor) -> torch.Tensor:
        """uint8 ``[*lead, nbytes]`` -> ``[*lead, *shape]``, bit-exact: a
        view of ``b`` (always, for uint8), or a copy where a view as the
        leaf's dtype would need a start and row strides in whole
        elements that ``b`` does not have."""
        size = self.dtype.itemsize
        if b.storage_offset() % size or any(st % size
                                            for st in b.stride()[:-1]):
            b = b.clone(memory_format=torch.contiguous_format)
        return b.view(self.dtype).view(b.shape[:-1] + self.shape)


@dataclass(frozen=True)
class NarrowIntCodec:
    """int32 indices in [0, 2^(8*width)) as ``width`` byte planes."""
    shape: tuple[int, ...]
    width: int                      # 2 (uint16) or 3 (uint24)

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.width

    @property
    def cid(self) -> str:
        return f"u{8 * self.width}"

    def pack(self, x: torch.Tensor,
             out: torch.Tensor | None = None) -> torch.Tensor:
        """``[*lead, *shape]`` -> uint8 ``[*lead, nbytes]``, written into
        ``out`` if given (on the card ``narrow_encode`` writes the planes
        where ``out`` lies)."""
        lead = x.shape[:x.ndim - len(self.shape)]
        assert tuple(x.shape[len(lead):]) == self.shape, (x.shape, self.shape)
        return narrow_encode(
            x.reshape(lead + (-1,)).to(torch.int32).contiguous(), self.width,
            out=out)

    def unpack(self, b: torch.Tensor) -> torch.Tensor:
        """uint8 ``[*lead, nbytes]``, a column of the stage buffer that
        ``narrow_decode`` reads in place, -> int32 ``[*lead, *shape]``."""
        return narrow_decode(b, self.width).view(b.shape[:-1] + self.shape)


def index_domains(comp: Any, slice_shape: tuple[int, ...]) -> dict[str, int]:
    """Payload-leaf name -> index domain size, for leaves that hold
    positions rather than values (eligible for narrow encoding)."""
    inner = comp.inner if isinstance(comp, C.WithNatural) else comp
    if isinstance(inner, C.TopK):
        return {"indices": math.prod(slice_shape)}
    if isinstance(inner, C.ColumnTopK):
        return {"indices": int(slice_shape[-1])}
    return {}


def leaf_codecs(comp: Any, slice_shape: tuple[int, ...],
                payload_struct: Any) -> tuple[tuple, tuple]:
    """(codecs, leaf names) for one compressor's per-slice payload.

    ``payload_struct`` is the payload of one slice (on the ``meta``
    device: only shapes and dtypes are read); codecs come in
    ``flatten_payload`` order."""
    names, leaves = flatten_payload(payload_struct)
    domains = index_domains(comp, slice_shape)
    codecs = []
    for name, leaf in zip(names, leaves):
        shape = tuple(leaf.shape)
        if name in domains and not leaf.dtype.is_floating_point:
            width = narrow_width(domains[name])
            if width < 4:
                codecs.append(NarrowIntCodec(shape, width))
                continue
        codecs.append(RawCodec(shape, leaf.dtype))
    return tuple(codecs), names
