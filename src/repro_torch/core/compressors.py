"""Contractive compressors (Def. 1, §D).

Port of ``repro/core/compressors.py``. The reference vmaps every
compressor over a leaf's worker and stack dims; here each one works on
``[*lead, *slice_shape]`` directly, one independent message per leading
index, and its state carries the same lead dims:

    comp = RankK(fraction=0.1)
    state = comp.init(generator, slice_shape, dtype, lead, device)
    payload, state = comp.compress(state, x, slice_shape)
    x_hat = comp.decompress(payload, x.shape, dtype)
    comp.payload_bytes(slice_shape, dtype)                # analytic bytes

Included compressors and the norm w.r.t. which they are contractive:
  Identity        alpha = 1            (any norm)
  TopK            Euclidean            (B_2)
  RankK           spectral/Frobenius   (PowerSGD-style subspace iteration,
                                        Newton-Schulz orthonormalisation,
                                        warm-started sketches; Remark 11)
  TopKSVD         any Schatten norm    (exact truncated SVD, Def. 10)
  ColumnTopK      mixed l_{p,q}        (Def. 13, p=2)
  Natural         elementwise, 8/9     (round to the nearest power of two)
  RandomDropout   any norm, alpha=p    (Def. 9)
  Damping         any norm             (Def. 8)
  WithNatural(C)  Natural on the float leaves of C's payload (the paper's
                  TopK+Natural and RankK+Natural)

Natural's encode and RankK's sketch orthonormalisation run the CUDA
kernels of ``kernels/`` for tensors on the card; their plain versions
for tensors on the CPU. On the ``meta`` device (the wire layout's shape
pass) compress computes shapes only and launches nothing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, ClassVar

import torch

from repro_torch.kernels.ops import (natural_compress, natural_decompress,
                                     newton_schulz_batched)

from .error_feedback import cast

Payload = Any
State = Any


def _nelem(shape) -> int:
    return int(math.prod(shape)) if shape else 1


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# the integer dtype of each element width, to move values as their bits
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _scatter_last(vals: torch.Tensor, idx: torch.Tensor,
                  shape: tuple[int, ...]) -> torch.Tensor:
    """Zeros of ``shape`` with ``vals`` put at ``idx`` along the last
    dim, with ``jnp .at[].set``'s semantics: an index in [-n, 0) wraps
    once, one still outside [0, n) is dropped. The masking is built on
    the device: such an index goes to a scratch slot one past the end,
    sliced off. (A wire whose bytes were flipped decodes to such
    indices; ``scatter_`` would raise on the CPU and assert on the card.)
    Scattered as integers of the values' width: PyTorch's CPU
    ``scatter_`` of bf16 turns every NaN into 0xFFFF, where the
    reference's scatter keeps its bits. Where indices repeat, which one
    lands is the scatter's: the CPU's keeps the last, as the reference's
    CPU scatter does; the card's promises no order."""
    bits = _BITS[vals.element_size()]
    n = shape[-1]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx < 0) | (idx >= n), n, idx)
    out = torch.zeros(tuple(shape[:-1]) + (n + 1,), dtype=bits,
                      device=vals.device)
    out.scatter_(-1, idx, vals.view(bits))
    return out[..., :n].view(vals.dtype)


def _gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, idx)`` as integers of the values' width: the
    CPU's gather of bf16 turns a NaN into 0xFFFF, where the reference's
    keeps its bits (a NaN gradient reaches TopK's values so)."""
    bits = _BITS[x.element_size()]
    return torch.gather(x.view(bits), -1, idx).view(x.dtype)


def _top_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of each row of ``score``, in
    ``jax.lax.top_k``'s order: descending, ties by the lower index first
    (a stable descending sort; ``torch.topk`` promises no order among
    ties)."""
    _, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return idx[..., :k]


@dataclass(frozen=True)
class Identity:
    """True identity (the paper's "ID"). ``lossless_wire``: the payload
    carries the exact f32 difference, with no wire-dtype quantisation."""
    name: str = "identity"
    lossless_wire: ClassVar[bool] = True

    def init(self, generator, shape, dtype, lead=(), device=None) -> State:
        return {}

    def compress(self, state, x, slice_shape):
        return x, state

    def decompress(self, payload, shape, dtype):
        return payload.to(dtype).reshape(shape)

    def payload_bytes(self, shape, dtype) -> int:
        return _nelem(shape) * _itemsize(dtype)


@dataclass(frozen=True)
class Damping:
    """C(x) = gamma * x; contractive with alpha = 1-(1-gamma)^2 (Def. 8)."""
    gamma: float = 0.5
    lossless_wire: ClassVar[bool] = False

    @property
    def name(self):
        return f"damping{self.gamma}"

    def init(self, generator, shape, dtype, lead=(), device=None) -> State:
        return {}

    def compress(self, state, x, slice_shape):
        return cast(self.gamma * x.to(torch.float32), x.dtype), state

    def decompress(self, payload, shape, dtype):
        return payload.to(dtype).reshape(shape)

    def payload_bytes(self, shape, dtype) -> int:
        return _nelem(shape) * _itemsize(dtype)


@dataclass(frozen=True)
class RandomDropout:
    """C(x) = x w.p. p else 0, one draw per message; contractive with
    alpha = p (Def. 9).

    Its randomness lives in its state: ``init`` seeds a generator of its
    own from the caller's, and ``compress`` draws each message's keep bit
    from it (never from torch's global generator). ``keep`` injects the
    bits instead (``[*lead]`` bool), as a test against the reference,
    which draws them from ``jax.random``, does."""
    p: float = 0.5
    lossless_wire: ClassVar[bool] = False

    @property
    def name(self):
        return f"dropout{self.p}"

    def init(self, generator, shape, dtype, lead=(), device=None) -> State:
        if generator is None:
            return {"generator": None}
        seed = int(torch.randint(0, 2**62, (1,), generator=generator))
        return {"generator": torch.Generator().manual_seed(seed)}

    def compress(self, state, x, slice_shape, keep=None):
        lead = x.shape[:x.ndim - len(slice_shape)]
        if keep is None:
            if x.device.type == "meta":
                keep = torch.empty(lead, dtype=torch.bool, device="meta")
            elif state["generator"] is None:
                raise ValueError("RandomDropout needs the state of an init "
                                 "with a torch.Generator, or keep bits")
            else:
                keep = torch.rand(lead, generator=state["generator"]) < self.p
        keep = keep.to(x.device)
        mask = keep.reshape(lead + (1,) * len(slice_shape))
        return {"keep": keep,
                "x": torch.where(mask, x, torch.zeros_like(x))}, state

    def decompress(self, payload, shape, dtype):
        return payload["x"].to(dtype).reshape(shape)

    def payload_bytes(self, shape, dtype) -> int:
        # expected wire cost: the full message w.p. p, 1 bit otherwise
        return int(self.p * _nelem(shape) * _itemsize(dtype)) + 1


@dataclass(frozen=True)
class TopK:
    """Keep the k = ceil(fraction * n) largest-magnitude entries of each
    slice. Ties at the k-th magnitude go as ``jax.lax.top_k`` breaks
    them (``_top_indices``); the payload is bf16 on the wire, so such
    ties are common."""
    fraction: float = 0.1
    lossless_wire: ClassVar[bool] = False
    # the reference's compiled E + decompress(payload) keeps the scattered
    # delta's NaN before E's (XLA on the CPU; core/error_feedback.py)
    delta_nan_first: ClassVar[bool] = True

    @property
    def name(self):
        return f"top{int(self.fraction * 100)}%"

    def k_for(self, shape) -> int:
        return max(1, int(math.ceil(self.fraction * _nelem(shape))))

    def init(self, generator, shape, dtype, lead=(), device=None) -> State:
        return {}

    def compress(self, state, x, slice_shape):
        flat = _rows(x, slice_shape)
        idx = _top_indices(flat.abs(), self.k_for(slice_shape))
        return {"values": _gather_last(flat, idx),
                "indices": idx.to(torch.int32)}, state

    def decompress(self, payload, shape, dtype):
        vals = payload["values"]
        lead = vals.shape[:-1]
        n = _nelem(shape) // _nelem(lead)
        return _scatter_last(vals, payload["indices"], lead + (n,)) \
            .reshape(shape).to(dtype)

    def payload_bytes(self, shape, dtype) -> int:
        return self.k_for(shape) * (_itemsize(dtype) + 4)


@dataclass(frozen=True)
class ColumnTopK:
    """Keep the K columns of largest l2 norm of each ``[m, n]`` slice
    (Def. 13, p=2); contractive w.r.t. the mixed l_{2,q} norms (and
    Frobenius). Column ties go as in TopK."""
    fraction: float = 0.1
    lossless_wire: ClassVar[bool] = False

    @property
    def name(self):
        return f"coltop{int(self.fraction * 100)}%"

    def k_for(self, shape) -> int:
        return max(1, int(math.ceil(self.fraction * shape[-1])))

    def init(self, generator, shape, dtype, lead=(), device=None) -> State:
        return {}

    def compress(self, state, x, slice_shape):
        if len(slice_shape) != 2:
            raise ValueError("ColumnTopK expects a matrix")
        colnorm = torch.sum(torch.square(x.to(torch.float32)), dim=-2)
        idx = _top_indices(colnorm, self.k_for(slice_shape))
        cols = _gather_last(x, idx[..., None, :].expand(
            x.shape[:-1] + idx.shape[-1:]))
        return {"cols": cols, "indices": idx.to(torch.int32)}, state

    def decompress(self, payload, shape, dtype):
        cols = payload["cols"]
        idx = payload["indices"][..., None, :].expand(cols.shape)
        return _scatter_last(cols, idx, tuple(shape)).to(dtype)

    def payload_bytes(self, shape, dtype) -> int:
        k = self.k_for(shape)
        return k * shape[0] * _itemsize(dtype) + 4 * k


def _orthonormalise(p: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Newton-Schulz on the columns of each ``[m, r]`` slice of ``p``
    (``[L, m, r]`` f32), as ``newton_schulz_ref``: on the transpose
    ``[L, r, m]`` when m > r, each slice normalised by its f32 Frobenius
    norm (eps 1e-7). The NS kernels on the card, the plain chain on the
    CPU; on ``meta`` only the shape, which NS keeps. Returns ``[L, m, r]``
    contiguous."""
    if p.device.type == "meta":
        return torch.empty_like(p)
    transpose = p.shape[-2] > p.shape[-1]
    x = p.mT.contiguous() if transpose else p
    x = newton_schulz_batched(x, steps=steps)
    return (x.mT if transpose else x).contiguous()


@dataclass(frozen=True)
class RankK:
    """PowerSGD-style rank-K compression with Newton-Schulz
    orthonormalisation and warm-started sketches.

    compress(x [m, n]):  P = x Q;  P <- ns_orth(P);  Qn = x^T P
    payload (P, Qn) in the wire dtype; decompress = P Qn^T. The state
    keeps Q = Qn (``[*lead, n, r]``, the warm start), so the subspace
    tracks the error-feedback residual across steps. Approximately
    contractive w.r.t. Frobenius/spectral norms (Remark 11). Every slice
    of ``[*lead, m, n]`` is its own message: one batched product and one
    batched NS chain per call."""
    fraction: float | None = None   # rank = ceil(fraction * min(m, n)) ...
    rank: int | None = None         # ... or a fixed rank
    lossless_wire: ClassVar[bool] = False

    @property
    def name(self):
        if self.rank is not None:
            return f"rank{self.rank}"
        return f"rank{int(self.fraction * 100)}%"

    def rank_for(self, shape) -> int:
        r_max = min(shape[-2], shape[-1])
        if self.rank is not None:
            return min(self.rank, r_max)
        return max(1, min(r_max, int(math.ceil(self.fraction * r_max))))

    def init(self, generator, shape, dtype, lead=(), device=None) -> State:
        """``q`` ``[*lead, n, r]``: standard normal draws from
        ``generator`` (on the CPU), each column normalised (+1e-12), in
        ``dtype`` on ``device``. On ``meta`` only the shape."""
        if len(shape) != 2:
            raise ValueError("RankK expects a matrix")
        qshape = tuple(lead) + (shape[1], self.rank_for(shape))
        if torch.device(device or "cpu").type == "meta":
            return {"q": torch.empty(qshape, dtype=dtype, device="meta")}
        if generator is None:
            raise ValueError("RankK.init draws its sketches from an "
                             "explicit torch.Generator; got None")
        q = torch.randn(qshape, generator=generator, dtype=torch.float32)
        q = q / (torch.linalg.norm(q, dim=-2, keepdim=True) + 1e-12)
        # no NaN among the draws, so PyTorch's cast gives XLA's bits
        return {"q": q.to(dtype).to(device)}

    def compress(self, state, x, slice_shape):
        lead = x.shape[:x.ndim - 2]
        m, n = slice_shape
        r = state["q"].shape[-1]
        xf = x.to(torch.float32).reshape((-1, m, n))
        q = state["q"].to(torch.float32).reshape((-1, n, r))
        p = _orthonormalise(torch.bmm(xf, q))
        qn = torch.bmm(xf.mT, p)
        qw = cast(qn, x.dtype)
        payload = {"p": cast(p, x.dtype).reshape(lead + (m, r)),
                   "q": qw.reshape(lead + (n, r))}
        qs = (qw if state["q"].dtype == x.dtype
              else cast(qn, state["q"].dtype))
        return payload, {"q": qs.reshape(lead + (n, r))}

    def decompress(self, payload, shape, dtype):
        out = payload["p"].to(torch.float32) \
            @ payload["q"].to(torch.float32).mT
        return out.reshape(shape).to(dtype)

    def payload_bytes(self, shape, dtype) -> int:
        r = self.rank_for(shape)
        return (shape[0] + shape[1]) * r * _itemsize(dtype)


@dataclass(frozen=True)
class TopKSVD:
    """Exact truncated SVD (Def. 10), contractive for all Schatten norms;
    ``torch.linalg.svd`` (off the main path, as in the reference). The
    payload is f32, as the reference's. On ``meta`` only the factors'
    shapes."""
    rank: int = 1
    lossless_wire: ClassVar[bool] = False

    @property
    def name(self):
        return f"svd{self.rank}"

    def init(self, generator, shape, dtype, lead=(), device=None) -> State:
        return {}

    def compress(self, state, x, slice_shape):
        lead = x.shape[:x.ndim - 2]
        m, n = slice_shape
        r = min(self.rank, m, n)
        if x.device.type == "meta":
            return {"us": torch.empty(lead + (m, r), device="meta"),
                    "vt": torch.empty(lead + (r, n), device="meta")}, state
        u, s, vt = torch.linalg.svd(x.to(torch.float32), full_matrices=False)
        return {"us": u[..., :r] * s[..., None, :r],
                "vt": vt[..., :r, :]}, state

    def decompress(self, payload, shape, dtype):
        return (payload["us"] @ payload["vt"]).reshape(shape).to(dtype)

    def payload_bytes(self, shape, dtype) -> int:
        return (shape[0] + shape[1]) * self.rank * _itemsize(dtype)


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

    def init(self, generator, shape, dtype, lead=(), device=None) -> State:
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
    paper's TopK+Natural and RankK+Natural): each float leaf ``name`` of
    a slice's payload becomes ``name_codes`` and ``name_signs``, one
    Natural row per slice. Over Identity the inner payload is the slice
    itself, so the whole message is Natural-compressed; quantisation
    makes the wrapper lossy whatever the inner compressor."""
    inner: Any
    lossless_wire: ClassVar[bool] = False

    @property
    def name(self):
        return f"{self.inner.name}+natural"

    def init(self, generator, shape, dtype, lead=(), device=None) -> State:
        return self.inner.init(generator, shape, dtype, lead, device)

    def _float_leaf_shapes(self, shape) -> dict[str, tuple[int, ...]]:
        """Per-slice shapes of the float leaves of a dict payload."""
        if isinstance(self.inner, TopK):
            return {"values": (self.inner.k_for(shape),)}
        if isinstance(self.inner, RankK):
            r = self.inner.rank_for(shape)
            return {"p": (shape[0], r), "q": (shape[1], r)}
        if isinstance(self.inner, TopKSVD):
            r = self.inner.rank
            return {"us": (shape[0], r), "vt": (r, shape[1])}
        raise TypeError(f"WithNatural does not support {type(self.inner)}")

    def compress(self, state, x, slice_shape):
        payload, state = self.inner.compress(state, x, slice_shape)
        if isinstance(self.inner, Identity):
            codes, signs = natural_compress(_rows(payload, slice_shape))
            return {"codes": codes, "signs": signs}, state
        lead = x.shape[:x.ndim - len(slice_shape)]
        out = dict(payload)
        for name in self._float_leaf_shapes(slice_shape):
            codes, signs = natural_compress(
                out.pop(name).reshape(lead + (-1,)))
            out[name + "_codes"] = codes
            out[name + "_signs"] = signs
        return out, state

    def decompress(self, payload, shape, dtype):
        if isinstance(self.inner, Identity):
            return self.inner.decompress(natural_decompress(
                payload["codes"], payload["signs"], shape, torch.bfloat16),
                shape, dtype)
        inner = dict(payload)
        lead = next(v.shape[:-1] for k, v in payload.items()
                    if k.endswith("_codes"))
        for name, lshape in self._float_leaf_shapes(
                tuple(shape[len(lead):])).items():
            inner[name] = natural_decompress(
                inner.pop(name + "_codes"), inner.pop(name + "_signs"),
                lead + lshape, torch.bfloat16)
        return self.inner.decompress(inner, shape, dtype)

    def payload_bytes(self, shape, dtype) -> int:
        if isinstance(self.inner, TopK):
            k = self.inner.k_for(shape)
            return k * 4 + k + (k + 7) // 8
        if isinstance(self.inner, (RankK, TopKSVD)):
            r = (self.inner.rank_for(shape) if isinstance(self.inner, RankK)
                 else self.inner.rank)
            n = (shape[0] + shape[1]) * r
            return n + (n + 7) // 8
        if isinstance(self.inner, Identity):
            n = _nelem(shape)
            return n + (n + 7) // 8
        raise TypeError(f"WithNatural does not support {type(self.inner)}")

    def rank_for(self, shape):
        return self.inner.rank_for(shape)


def empirical_alpha(comp, generator, x: torch.Tensor, n_trials: int = 8,
                    norm_kind: str = "frobenius") -> float:
    """Estimate the contractivity parameter alpha = 1 -
    E||C(x)-x||^2/||x||^2 over ``n_trials`` compressions of ``x`` (one
    message), the state carried from one to the next."""
    from .norms import norm
    shape = tuple(x.shape)
    state = comp.init(generator, shape, x.dtype, device=x.device)
    num = 0.0
    for _ in range(n_trials):
        payload, state = comp.compress(state, x, shape)
        xh = comp.decompress(payload, shape, torch.float32)
        num += float(norm(xh - x.to(torch.float32), norm_kind) ** 2)
    den = float(norm(x, norm_kind) ** 2)
    return 1.0 - num / (n_trials * den)


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
    "rank5": lambda: RankK(fraction=0.05),
    "rank10": lambda: RankK(fraction=0.10),
    "rank15": lambda: RankK(fraction=0.15),
    "rank20": lambda: RankK(fraction=0.20),
    "rank10+natural": lambda: WithNatural(RankK(fraction=0.10)),
    "rank15+natural": lambda: WithNatural(RankK(fraction=0.15)),
}


def get_compressor(name: str):
    if name not in REGISTRY:
        raise KeyError(f"unknown compressor '{name}'; have {sorted(REGISTRY)}")
    return REGISTRY[name]()
