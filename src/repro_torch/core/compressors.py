"""Contractive compressors (Def. 1, §D) — the port's first two.

Port of ``Identity`` and ``TopK`` from ``repro/core/compressors.py``.
The reference vmaps every compressor over a leaf's worker and stack
dims; here each one works on ``[*lead, *slice_shape]`` directly, one
independent message per leading index:

    comp = TopK(fraction=0.1)
    state = comp.init(generator, slice_shape, dtype)      # may be {}
    payload, state = comp.compress(state, x, slice_shape)
    x_hat = comp.decompress(payload, x.shape, dtype)
    comp.payload_bytes(slice_shape, dtype)                # analytic bytes

The other compressors of the reference's registry are still to port
(ROADMAP Queue 1 item 2); asking for one raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, ClassVar

import torch

Payload = Any
State = Any


def _nelem(shape) -> int:
    return int(math.prod(shape)) if shape else 1


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


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
        vals = payload["values"]
        lead = vals.shape[:-1]
        n = _nelem(shape) // _nelem(lead)
        flat = torch.zeros(lead + (n,), dtype=vals.dtype, device=vals.device)
        flat.scatter_(-1, payload["indices"].to(torch.int64), vals)
        return flat.reshape(shape).to(dtype)

    def payload_bytes(self, shape, dtype) -> int:
        return self.k_for(shape) * (_itemsize(dtype) + 4)


REGISTRY = {
    "identity": lambda: Identity(),
    "top5": lambda: TopK(0.05),
    "top10": lambda: TopK(0.10),
    "top15": lambda: TopK(0.15),
    "top20": lambda: TopK(0.20),
}

# the reference's registry beyond what the port runs
NOT_YET_PORTED = (
    "natural", "identity+natural", "top10+natural", "top15+natural",
    "rank5", "rank10", "rank15", "rank20", "rank10+natural",
    "rank15+natural",
)


def get_compressor(name: str):
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"compressor '{name}' is not ported to repro_torch yet: ROADMAP "
            "Queue 1 item 2 (the other compressors)")
    if name not in REGISTRY:
        raise KeyError(f"unknown compressor '{name}'; have {sorted(REGISTRY)}")
    return REGISTRY[name]()
