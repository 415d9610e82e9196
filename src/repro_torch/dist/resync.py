"""Desynchronized-worker rejoin: versioned W resync over the wire
(DESIGN.md §13).

Port of ``repro/dist/resync.py``. A worker absent across a
server->worker (s2w) broadcast would keep a stale model estimate W
forever after; the rejoin algebra brings it back:

  * a per-worker **version vector** ``vv`` (``[n_workers]`` int32):
    ``vv[j]`` is the number of s2w rounds worker j has applied, i.e. the
    round it needs next. Advanced by the reception mask each step,
    frozen for absent workers.
  * a bounded **replay ring** of the last R packed s2w rounds (``[R,
    total_s2w_nbytes]`` uint8: the ``wire/layout.py`` bytes verbatim,
    the stage sub-buffers concatenated in stage order). It is
    roll-pushed every round, so after the push slot ``r`` holds round
    ``step - (R-1) + r`` and slot ``R-1`` the current round.
  * the **replay masks**: a rejoining worker with lag <= R catches up
    by replaying the missed rounds through ``apply_payload``'s algebra
    (each slot decompressed once, shared by the workers: the broadcast
    was one message), in ascending round order, which gives the bits of
    having applied each round on time. A worker with lag > R takes a
    **full W resync**: a copy of the server's post-round W (in the step
    for a live process; a fresh process is served the same tree from the
    checkpoint, ``serve_full_resync``).

Reception is the scheduled participation AND the faults' drops
(``dist.participation.reception_mask``); guard demotion does not gate
it. A skipped step (every worker demoted) still advances the ring, the
version vector and the W estimates, as the server's W advances on it.

The masks are tensors on the step's device and every per-worker
decision is a ``torch.where``: the host knows only its step number. The
rejoin adds no collective (the ring is replicated, decompression is
local), so the wire's gathers and broadcasts keep their bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

# the reference's bound on one packed s2w row (XLA's int32 dimensions);
# the port keeps it so both packages accept the same configurations
_MAX_RING_ROW_NBYTES = 2**31 - 1


def resolve_ring_depth(resync: Any) -> int:
    """The replay-ring depth R: ``None``/``0``/``False`` turn the
    subsystem off (0, the step without it); an int >= 1 bounds the lag a
    worker can replay."""
    if resync is None or resync is False or resync == 0:
        return 0
    r = int(resync)
    if r < 1:
        raise ValueError(f"resync ring depth must be >= 1, got {resync!r}")
    return r


def init_resync_state(n_workers: int, ring_depth: int, row_nbytes: int,
                      device: str | torch.device = "cpu") -> dict:
    """Fresh resync state on ``device``: an all-zero version vector
    (every worker needs round 0 next) and a zeroed ring. Zero slots are
    never applied: at step t slot r holds round ``t - (R-1) + r`` and the
    replay mask needs ``round >= vv[j] >= 0``, so the rounds before the
    first are masked out."""
    if row_nbytes > _MAX_RING_ROW_NBYTES:
        raise ValueError(
            f"resync ring row ({row_nbytes} packed s2w bytes) exceeds the "
            f"XLA dimension limit ({_MAX_RING_ROW_NBYTES}); the replicated "
            "in-graph ring is not viable at this model scale — serve "
            "rejoining workers a full W resync out-of-process instead "
            "(dist.resync.serve_full_resync over the checkpoint archive)")
    return {
        "vv": torch.zeros(n_workers, dtype=torch.int32, device=device),
        "ring": torch.zeros((ring_depth, row_nbytes), dtype=torch.uint8,
                            device=device),
    }


def ring_push(ring: torch.Tensor, *parts: torch.Tensor,
              inplace: bool = False) -> torch.Tensor:
    """Roll-push the current round's packed s2w bytes into the ring: the
    oldest slot falls off the front and ``parts`` (1-D uint8, one per
    stage sub-buffer, in stage order; or the whole row) land, one after
    another, in slot R-1. So slot r holds round ``step - (R-1) + r``
    after the push. With ``inplace`` the ring's own tensor is rolled,
    slot by slot from the front (no copy overlaps its source), and
    returned; otherwise a new ring is."""
    out = ring if inplace else torch.empty_like(ring)
    for r in range(ring.shape[0] - 1):
        out[r].copy_(ring[r + 1])
    slot, pos = out[-1], 0
    for part in parts:
        slot[pos:pos + part.numel()].copy_(part.reshape(-1))
        pos += part.numel()
    if pos != ring.shape[1]:
        raise ValueError(f"ring row of {pos} bytes, the ring holds "
                         f"{ring.shape[1]}")
    return out


@dataclass(frozen=True)
class ReplayMasks:
    """One step's rejoin decision, ``[n_workers]``-shaped, on the device.

    ``apply[r, j]``: replay ring slot r into worker j's W estimate (slots
    in ascending r, i.e. ascending round order); ``full[j]``: worker j
    rejoins with lag > R and takes the full W copy instead; ``vv_new``:
    the advanced version vector. The int32 counts and the lag feed the
    metrics and the step's ``aux``."""
    apply: torch.Tensor       # [R, n_workers] bool
    full: torch.Tensor        # [n_workers] bool
    vv_new: torch.Tensor      # [n_workers] int32
    n_replayed: torch.Tensor  # workers that caught up by replay (lag >= 1)
    n_full: torch.Tensor      # workers that took the full W copy
    lag_max: torch.Tensor     # largest version lag after this round


def replay_masks(vv: torch.Tensor, step: int, recv: torch.Tensor,
                 ring_depth: int) -> ReplayMasks:
    """The rejoin masks of one round. ``vv`` is the version vector before
    it, ``step`` the round (the host's step number), ``recv`` the
    reception mask of its broadcast (bool, on ``vv``'s device). Worker j
    is replayable iff the round it needs is still in the ring (``vv[j] >=
    step - (R-1)``); it then applies every slot with ``round >= vv[j]``.
    A current worker (``vv == step``) applies exactly the current round:
    applying on time is the degenerate replay."""
    r = int(ring_depth)
    step = int(step)
    vv = vv.to(torch.int32)
    rounds = (step - (r - 1)) + torch.arange(r, dtype=torch.int32,
                                             device=vv.device)
    replayable = vv >= step - (r - 1)
    apply = (recv[None, :] & replayable[None, :]
             & (rounds[:, None] >= vv[None, :]))
    full = recv & ~replayable
    vv_new = torch.where(recv, torch.full_like(vv, step + 1), vv)
    n_replayed = torch.sum(recv & replayable & (vv < step),
                           dtype=torch.int32)
    n_full = torch.sum(full, dtype=torch.int32)
    lag_max = torch.max((step + 1) - vv_new).to(torch.int32)
    return ReplayMasks(apply=apply, full=full, vv_new=vv_new,
                       n_replayed=n_replayed, n_full=n_full,
                       lag_max=lag_max)


def serve_full_resync(path: str, state_like: Any) -> tuple[Any, int]:
    """Serve a fresh process's rejoin from the checkpoint
    (``train/checkpoint.py``, with its ``.prev`` fallback and checksum
    check): returns ``(w_tree, version)``, the server's model estimate W
    (the iterate X for an identity s2w leg, where W is X) and the step
    it is current at. The caller installs the tree as the worker's
    ``w_w[j]`` and sets ``vv[j] = version``; the step's replay takes
    over from there. The archive holds X and W whole under every
    placement: ``Trainer.save_checkpoint`` gathers the leaves a zero-1 or
    FSDP placement cuts before it writes."""
    from repro_torch.train.checkpoint import load_checkpoint
    state, step = load_checkpoint(path, state_like)
    if not isinstance(state, dict) or "x" not in state:
        raise ValueError(
            f"{path}: not an optimizer-state checkpoint (no 'x' entry)")
    w = state["w"] if state.get("w") is not None else state["x"]
    return w, int(step or 0)
