"""Per-payload-leaf wire codecs (DESIGN.md §6).

Port of ``repro/wire/codecs.py``. A codec is a bit-exact pair
``pack(rows) -> uint8 [R, nbytes]`` / ``unpack(uint8 [R, nbytes]) ->
rows`` for one fixed-shape payload leaf, over a batch of ``R`` rows (one
per worker and stack slice; the reference vmaps the same pair over
them). Two cover every compressor the port runs:

  RawCodec        any tensor, byte for byte (a dtype view): bf16 values,
                  Natural's uint8 code planes and packed sign bitmaps,
                  Identity's f32 differences, indices too wide to narrow.
  NarrowIntCodec  int32 indices whose domain fits 2 (uint16) or 3
                  (uint24) bytes — TopK's indices — as byte planes,
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

    def pack(self, x: torch.Tensor) -> torch.Tensor:
        """``[R, *shape]`` -> uint8 ``[R, nbytes]``."""
        assert tuple(x.shape[1:]) == self.shape, (x.shape, self.shape)
        return x.reshape(x.shape[0], -1).contiguous().view(torch.uint8)

    def unpack(self, b: torch.Tensor) -> torch.Tensor:
        """uint8 ``[R, nbytes]`` -> ``[R, *shape]``, bit-exact."""
        b = b.contiguous()
        if b.storage_offset() % self.dtype.itemsize:
            b = b.clone()       # a dtype view needs an aligned start
        return b.view(self.dtype).reshape((b.shape[0],) + self.shape)


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

    def pack(self, x: torch.Tensor) -> torch.Tensor:
        assert tuple(x.shape[1:]) == self.shape, (x.shape, self.shape)
        return narrow_encode(
            x.reshape(x.shape[0], -1).to(torch.int32).contiguous(),
            self.width)

    def unpack(self, b: torch.Tensor) -> torch.Tensor:
        """uint8 ``[R, nbytes]``, a column slice of the stage buffer that
        ``narrow_decode`` reads in place, -> int32 ``[R, *shape]``."""
        return narrow_decode(b, self.width).reshape(
            (b.shape[0],) + self.shape)


def index_domains(comp: Any, slice_shape: tuple[int, ...]) -> dict[str, int]:
    """Payload-leaf name -> index domain size, for leaves that hold
    positions rather than values (eligible for narrow encoding)."""
    inner = comp.inner if isinstance(comp, C.WithNatural) else comp
    if isinstance(inner, C.TopK):
        return {"indices": math.prod(slice_shape)}
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
