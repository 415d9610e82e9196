"""The EF21 worker axis over ``torch.distributed`` ranks (DESIGN.md §3).

Port of the worker-axis placement of ``repro/dist/sharding.py``
(``worker_axis_for``/``n_workers_for``, ``_worker_pspec``'s leading
worker dim, ``batch_pspec``'s train rule): a process group stands in for
the mesh's worker axis. With a group of P ranks and ``n_workers = P *
n_local``, rank r owns workers ``[r * n_local, (r + 1) * n_local)``: the
rows of every leaf with a leading worker dim (``g_w``, ``m_w``,
``cw_state``, ``w_w``; the train batch) that those workers index. The
server's state (``x``, ``g_server``, ``w``, ``cs_state``, the resync
version vector and ring) is replicated: every rank runs the same fold
and LMO on the gathered payload bytes, as the reference's replicated
server does. Each rank owns whole workers, as the reference shards only
a worker lead its axis divides. Tensor, FSDP and zero-1 placement have
no counterpart here: the port has no model axis.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

# the state's leaves whose leading dim is the worker axis
WORKER_LEAD_KEYS = ("g_w", "m_w", "cw_state", "w_w")

# all_gather_single is the newer name of all_gather_into_tensor (same
# arguments); the older torch on some installations has only the latter
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def n_workers_for(group) -> int:
    """Ranks of the worker axis: the group's size (1 without one). Each
    rank holds ``n_workers / n_workers_for(group)`` EF21 workers."""
    return 1 if group is None else group.size()


def rank_of(group) -> int:
    """This process's rank in ``group`` (0 without one)."""
    return 0 if group is None else dist.get_rank(group)


def local_workers(group, n_workers: int) -> range:
    """The global ids of the workers this rank owns; raises where the
    group's size does not divide ``n_workers``."""
    p = n_workers_for(group)
    if n_workers % p:
        raise ValueError(
            f"{n_workers} workers over a group of {p} ranks: each rank "
            "owns whole workers, so the group's size must divide n_workers")
    n_local = n_workers // p
    r = rank_of(group)
    return range(r * n_local, (r + 1) * n_local)


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return tree


def shard_workers(tree: Any, group, n_workers: int) -> Any:
    """This rank's rows of every ``[n_workers, ...]`` tensor of ``tree``
    (a tensor of another lead raises), each a copy of its own, so the
    other ranks' rows are freed with the global tensor."""
    rows = local_workers(group, n_workers)

    def one(t: torch.Tensor) -> torch.Tensor:
        if t.ndim == 0 or t.shape[0] != n_workers:
            raise ValueError(f"a worker-lead leaf of shape {tuple(t.shape)}"
                             f" for {n_workers} workers")
        if len(rows) == n_workers:
            return t
        return t[rows.start:rows.stop].clone()

    return _map(one, tree)


def worker_lead_paths(state: dict) -> tuple[str, ...]:
    """The keys of ``state`` whose leaves lead with the worker axis, in
    ``WORKER_LEAD_KEYS`` order (``m_w`` is None without momentum)."""
    return tuple(k for k in WORKER_LEAD_KEYS if state.get(k) is not None)


def shard_state(state: dict, group, n_workers: int) -> dict:
    """The rank's slice of a global EF21-Muon state: the worker-lead
    leaves (``worker_lead_paths``) sharded, the rest as it is."""
    out = dict(state)
    for key in worker_lead_paths(state):
        out[key] = shard_workers(state[key], group, n_workers)
    return out


def gather_tensor(t: torch.Tensor, group, record: list | None = None
                  ) -> torch.Tensor:
    """``[n_local, ...]`` on every rank -> ``[P * n_local, ...]``, rank
    order, by one all-gather in ``t``'s dtype (an int16 tensor, which
    gloo does not take, as its bytes); a collective copies bytes, so
    NaN payloads keep their bits. A gloo group moves a CUDA tensor
    through pinned host memory (``host_staged``). ``record`` gets the
    bytes each rank sent."""
    t = t.contiguous()
    wire = t.view(torch.uint8) if t.dtype == torch.int16 else t
    out = torch.empty((group.size() * wire.shape[0],)
                      + tuple(wire.shape[1:]), dtype=wire.dtype,
                      device=t.device)
    if host_staged(group, t):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        _all_gather(host, wire.cpu(), group=group)
        out.copy_(host)
    else:
        _all_gather(out, wire, group=group)
    if record is not None:
        record.append(t.numel() * t.element_size())
    return out.view(t.dtype)


def broadcast_tensor(t: torch.Tensor, group, src_rank: int = 0
                     ) -> torch.Tensor:
    """``t`` of the group's rank ``src_rank`` written into ``t`` on every
    rank, by one broadcast (through pinned host memory where
    ``host_staged``)."""
    src = dist.get_global_rank(group, src_rank)
    if host_staged(group, t):
        host = t.cpu().pin_memory()
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def gather_workers(tree: Any, group, record: list | None = None) -> Any:
    """Every worker-lead tensor of ``tree`` gathered from its ranks'
    slices (``gather_tensor``), in worker order."""
    return _map(lambda t: gather_tensor(t, group, record), tree)


def gather_state(state: dict, group, record: list | None = None) -> dict:
    """The global EF21-Muon state from the ranks' slices: every rank
    takes part (one all-gather per worker-lead tensor) and gets it."""
    out = dict(state)
    for key in worker_lead_paths(state):
        out[key] = gather_workers(state[key], group, record)
    return out


def host_staged(group, t: torch.Tensor) -> bool:
    """True where a collective of ``t`` goes through pinned host memory:
    a CUDA tensor over a gloo group (a gloo group is the transport of
    ranks that share one card, where NCCL refuses two ranks; its
    collectives take host tensors). Chosen by the group's backend, never
    after a failure: the compute stays on the card."""
    return (t.device.type == "cuda" and group is not None
            and dist.get_backend(group) == "gloo")
