"""Contractive compressors (Def. 1, §D).

Port of ``Identity``, ``TopK``, ``Natural`` and ``WithNatural`` (over
Identity and TopK) from ``repro/core/compressors.py``.
The reference vmaps every compressor over a leaf's worker and stack
dims; here each one works on ``[*lead, *slice_shape]`` directly, one
independent message per leading index:

    comp = TopK(fraction=0.1)
    state = comp.init(generator, slice_shape, dtype)      # may be {}
    payload, state = comp.compress(state, x, slice_shape)
    x_hat = comp.decompress(payload, x.shape, dtype)
    comp.payload_bytes(slice_shape, dtype)                # analytic bytes

Natural's encode runs the CUDA kernels of ``kernels/natural_pack.py``
and ``kernels/bitpack.py`` for tensors on the card. The low-rank
compressors of the reference's registry are still to port (ROADMAP
Queue 1 item 2); asking for one raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, ClassVar

import torch

from repro_torch.kernels.ops import natural_compress, natural_decompress

Payload = Any
State = Any


def _nelem(shape) -> int:
    return int(math.prod(shape)) if shape else 1


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# the integer dtype of each element width, to move values as their bits
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@dataclass(frozen=True)
class Identity:
    """True identity (the paper's "ID"). ``lossless_wire``: the payload
    carries the exact f32 difference, with no wire-dtype quantisation."""
    name: str = "identity"
    lossless_wire: ClassVar[bool] = True

    def init(self, generator, shape, dtype) -> State:
        return {}

    def compress(self, state, x, slice_shape):
        return x, state

    def decompress(self, payload, shape, dtype):
        return payload.to(dtype).reshape(shape)

    def payload_bytes(self, shape, dtype) -> int:
        return _nelem(shape) * _itemsize(dtype)


@dataclass(frozen=True)
class TopK:
    """Keep the k = ceil(fraction * n) largest-magnitude entries of each
    slice.

    Ties at the k-th magnitude are broken as ``jax.lax.top_k`` breaks
    them — the lower flat index first — by a stable descending sort
    (``torch.topk`` promises no order among ties). The payload is bf16
    on the wire, so such ties are common."""
    fraction: float = 0.1
    lossless_wire: ClassVar[bool] = False

    @property
    def name(self):
        return f"top{int(self.fraction * 100)}%"

    def k_for(self, shape) -> int:
        return max(1, int(math.ceil(self.fraction * _nelem(shape))))

    def init(self, generator, shape, dtype) -> State:
        return {}

    def compress(self, state, x, slice_shape):
        lead = x.shape[:x.ndim - len(slice_shape)]
        flat = x.reshape(lead + (_nelem(slice_shape),))
        k = self.k_for(slice_shape)
        _, idx = torch.sort(flat.abs(), dim=-1, descending=True, stable=True)
        idx = idx[..., :k]
        return {"values": torch.gather(flat, -1, idx),
                "indices": idx.to(torch.int32)}, state

    def decompress(self, payload, shape, dtype):
        # scattered as integers of the values' width: PyTorch's CPU
        # scatter_ of bf16 turns every NaN into 0xFFFF, where the
        # reference's scatter keeps its bits
        vals = payload["values"]
        lead = vals.shape[:-1]
        n = _nelem(shape) // _nelem(lead)
        bits = _BITS[vals.element_size()]
        flat = torch.zeros(lead + (n,), dtype=bits, device=vals.device)
        flat.scatter_(-1, payload["indices"].to(torch.int64), vals.view(bits))
        return flat.view(vals.dtype).reshape(shape).to(dtype)

    def payload_bytes(self, shape, dtype) -> int:
        return self.k_for(shape) * (_itemsize(dtype) + 4)


def _rows(x: torch.Tensor, slice_shape) -> torch.Tensor:
    """``[*lead, *slice_shape]`` -> ``[*lead, n]``, one row per slice."""
    lead = x.shape[:x.ndim - len(slice_shape)]
    return x.reshape(lead + (_nelem(slice_shape),))


@dataclass(frozen=True)
class Natural:
    """Round to the nearest power of two; 9 bits per value on the wire.

    Elementwise relative error <= 1/3, so contractive with alpha = 8/9
    in every absolute norm. Payload per slice: ``codes`` uint8 [n] and
    ``signs`` uint8 [ceil(n/8)] (the sign bitmap, padded per slice)."""
    name: str = "natural"
    lossless_wire: ClassVar[bool] = False

    def init(self, generator, shape, dtype) -> State:
        return {}

    def compress(self, state, x, slice_shape):
        codes, signs = natural_compress(_rows(x, slice_shape))
        return {"codes": codes, "signs": signs}, state

    def decompress(self, payload, shape, dtype):
        return natural_decompress(payload["codes"], payload["signs"], shape,
                                  dtype)

    def payload_bytes(self, shape, dtype) -> int:
        n = _nelem(shape)
        return n + (n + 7) // 8


@dataclass(frozen=True)
class WithNatural:
    """Natural on the float leaves of an inner compressor's payload (the
    paper's TopK+Natural). Over Identity the inner payload is the slice
    itself, so the whole message is Natural-compressed; quantisation
    makes the wrapper lossy whatever the inner compressor."""
    inner: Any
    lossless_wire: ClassVar[bool] = False

    @property
    def name(self):
        return f"{self.inner.name}+natural"

    def init(self, generator, shape, dtype) -> State:
        return self.inner.init(generator, shape, dtype)

    def _float_leaves(self) -> tuple[str, ...]:
        if isinstance(self.inner, TopK):
            return ("values",)
        raise TypeError(f"WithNatural does not support {type(self.inner)}")

    def compress(self, state, x, slice_shape):
        payload, state = self.inner.compress(state, x, slice_shape)
        if isinstance(self.inner, Identity):
            codes, signs = natural_compress(_rows(payload, slice_shape))
            return {"codes": codes, "signs": signs}, state
        out = dict(payload)
        for name in self._float_leaves():
            codes, signs = natural_compress(out.pop(name))
            out[name + "_codes"] = codes
            out[name + "_signs"] = signs
        return out, state

    def decompress(self, payload, shape, dtype):
        if isinstance(self.inner, Identity):
            return self.inner.decompress(natural_decompress(
                payload["codes"], payload["signs"], shape, torch.bfloat16),
                shape, dtype)
        inner = dict(payload)
        for name in self._float_leaves():
            codes = inner.pop(name + "_codes")
            inner[name] = natural_decompress(
                codes, inner.pop(name + "_signs"), codes.shape,
                torch.bfloat16)
        return self.inner.decompress(inner, shape, dtype)

    def payload_bytes(self, shape, dtype) -> int:
        if isinstance(self.inner, TopK):
            k = self.inner.k_for(shape)
            return k * 4 + k + (k + 7) // 8
        if isinstance(self.inner, Identity):
            n = _nelem(shape)
            return n + (n + 7) // 8
        raise TypeError(f"WithNatural does not support {type(self.inner)}")


REGISTRY = {
    "identity": lambda: Identity(),
    "natural": lambda: Natural(),
    "identity+natural": lambda: WithNatural(Identity()),
    "top5": lambda: TopK(0.05),
    "top10": lambda: TopK(0.10),
    "top15": lambda: TopK(0.15),
    "top20": lambda: TopK(0.20),
    "top10+natural": lambda: WithNatural(TopK(0.10)),
    "top15+natural": lambda: WithNatural(TopK(0.15)),
}

# the reference's registry beyond what the port runs
NOT_YET_PORTED = (
    "rank5", "rank10", "rank15", "rank20", "rank10+natural",
    "rank15+natural",
)


def get_compressor(name: str):
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"compressor '{name}' is not ported to repro_torch yet: ROADMAP "
            "Queue 1 item 2 (the low-rank compressors)")
    if name not in REGISTRY:
        raise KeyError(f"unknown compressor '{name}'; have {sorted(REGISTRY)}")
    return REGISTRY[name]()
