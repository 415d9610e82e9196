"""Elastic per-step worker participation (DESIGN.md §11).

Port of ``repro/dist/participation.py``. A worker that skips a round
freezes its EF21 error state (G_j, momentum, compressor states) while
the server folds only the participants, normalised by the dynamic
participant count; the wire collectives keep their static shapes and
absence is applied at fold and commit time.

  * ``participation_mask(spec, n, step, seed)`` — the ``[n_workers]``
    bool mask of one step: a pure function of (spec, seed, step),
    computed on the host in numpy (a resumed run draws the same history)
    and handed to the device by ``mask_to_device`` without a sync.
  * ``payload_finite_mask(payloads, n)`` — the non-finite guard: a
    per-worker finiteness reduction over the float leaves of the
    (unpacked) payloads, on the device.

Schedules (``spec`` is a string or an ``Explicit`` instance):

  ``"full"``            every worker, every step (the bit-equal arm —
                        the optimizer skips the masked path entirely)
  ``"bernoulli(p)"``    each worker participates i.i.d. w.p. ``p`` per
                        step: the reference's draw,
                        ``jax.random.bernoulli(fold_in(key(seed), step),
                        p, (n,))``, bit for bit (threefry2x32 below)
  ``"round_robin(k)"``  a rotating contiguous window of ``k`` workers
  ``Explicit(masks)``   an explicit mask table, indexed ``step % len``
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

_BERNOULLI_RE = re.compile(r"^bernoulli\(([0-9.eE+-]+)\)$")
_ROUND_ROBIN_RE = re.compile(r"^round_robin\(([0-9]+)\)$")


@dataclass(frozen=True)
class Explicit:
    """Explicit per-step mask table: ``masks[step % len(masks)]``, a
    tuple of length-``n_workers`` tuples of 0/1."""
    masks: tuple

    def __post_init__(self):
        if not self.masks:
            raise ValueError("Explicit participation needs >= 1 mask")
        n = len(self.masks[0])
        if any(len(m) != n for m in self.masks):
            raise ValueError("Explicit masks must all have the same length")


def validate_spec(spec, n_workers: int) -> None:
    """Raise ValueError on a malformed participation spec (at step-build
    time, so CLI typos fail fast)."""
    if isinstance(spec, Explicit):
        if len(spec.masks[0]) != n_workers:
            raise ValueError(
                f"Explicit masks are for {len(spec.masks[0])} workers, "
                f"optimizer has {n_workers}")
        return
    if not isinstance(spec, str):
        raise ValueError(f"participation spec must be str or Explicit, "
                         f"got {type(spec).__name__}")
    if spec == "full":
        return
    m = _BERNOULLI_RE.match(spec)
    if m:
        p = float(m.group(1))
        if not 0.0 < p <= 1.0:
            raise ValueError(f"bernoulli(p) needs 0 < p <= 1, got {p}")
        return
    m = _ROUND_ROBIN_RE.match(spec)
    if m:
        k = int(m.group(1))
        if not 1 <= k <= n_workers:
            raise ValueError(
                f"round_robin(k) needs 1 <= k <= {n_workers}, got {k}")
        return
    raise ValueError(
        f"unknown participation spec {spec!r}; expected 'full', "
        f"'bernoulli(p)', 'round_robin(k)' or an Explicit mask table")


# ------------------------------------------------- JAX's threefry2x32 PRNG

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) as ``jax.random``'s
    ``threefry2x32`` computes it, on uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in`` for a 32-bit ``data``."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32),
                        np.asarray([data & 0xFFFFFFFF], np.uint32))
    return int(a[0]), int(b[0])


def bernoulli_mask(p: float, n: int, seed: int, step: int) -> np.ndarray:
    """``jax.random.bernoulli(fold_in(key(seed), step), p, (n,))``: the
    partitionable threefry bits of counter i (0, i), the f32 uniform of
    their top 23 bits, then ``u < p`` in f32."""
    key = _fold_in((0, seed & 0xFFFFFFFF), step)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, np.zeros(n, np.uint32),
                              np.arange(n, dtype=np.uint32))
    bits = b0 ^ b1
    u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    return u < np.float32(p)


def participation_mask(spec, n_workers: int, step: int,
                       seed: int = 0) -> np.ndarray:
    """The ``[n_workers]`` bool participation mask of ``step``, a pure
    function of (spec, seed, step)."""
    step = int(step)
    if isinstance(spec, Explicit):
        return np.asarray(spec.masks[step % len(spec.masks)], dtype=bool)
    if spec == "full":
        return np.ones(n_workers, dtype=bool)
    m = _BERNOULLI_RE.match(spec)
    if m:
        return bernoulli_mask(float(m.group(1)), n_workers, seed, step)
    m = _ROUND_ROBIN_RE.match(spec)
    if m:
        k = int(m.group(1))
        # rotating contiguous window: step s keeps workers
        # {(s*k + i) mod n : i < k}
        start = (step * k) % n_workers
        return (np.arange(n_workers) - start) % n_workers < k
    raise ValueError(f"unknown participation spec {spec!r}")


def mask_to_device(mask: np.ndarray, device) -> torch.Tensor:
    """A host mask as a bool tensor on ``device``: an asynchronous copy,
    so the step waits on nothing."""
    return torch.from_numpy(np.ascontiguousarray(mask, dtype=bool)).to(
        device, non_blocking=True)


def payload_finite_mask(payloads, n_workers: int,
                        device) -> torch.Tensor:
    """Per-worker payload finiteness: ``[n_workers]`` bool on ``device``,
    False for any worker whose payload carries a non-finite float.
    ``payloads`` is the per-leaf list of payloads (tensors or dicts of
    tensors, each ``[n_workers, ...]``). Only floating leaves are
    checked: an index or code leaf cannot hold a NaN (a flipped index
    decodes to a wrong but finite scatter, a flipped Natural code to a
    power of two, +-inf included)."""
    from repro_torch.wire.codecs import flatten_payload
    flags = torch.ones(n_workers, dtype=torch.bool, device=device)
    for pl in payloads:
        for leaf in flatten_payload(pl)[1]:
            if not leaf.is_floating_point():
                continue
            fin = torch.isfinite(leaf.reshape(n_workers, -1))
            flags = flags & torch.all(fin, dim=1)
    return flags


def mask_bcast(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a ``[n]`` mask to broadcast against ``[n, ...]`` of rank
    ``ndim``."""
    return mask.reshape(mask.shape + (1,) * (ndim - 1))
