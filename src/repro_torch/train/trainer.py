"""EF21-Muon trainer.

Port of ``repro/train/trainer.py``: model loss, the EF21Muon optimizer,
the per-worker gradient function and, with a ``torch.distributed``
process group (the counterpart of the reference's mesh), the two
communication hooks. The dataflow per step (DESIGN.md §5):

  1. EF21-P (``s2w``): the server compresses S = C_P(X - W); with a
     group it is packed into uint8 wire buffers of lead 1 (one per wire
     stage) and each broadcast from the group's rank 0, and both ends
     advance W from the bytes; ``s2w="identity"`` keeps W = X;
  2. per-worker grads at W, one autograd pass per worker;
  3. per-worker momentum + EF21 compress: R_j = C_D(M_j - G_j);
  4. with a group, the payloads packed into uint8 wire buffers
     (``repro_torch.wire``; one per wire stage) and each all-gathered
     over the group; without one, nothing is packed;
  5. server fold G += mean_j decompress(R_j), then X = LMO_B(X, t)(G),
     the spectral leaves through the batched Newton-Schulz chain (the
     CUDA kernels on the card).

``TrainerConfig`` adds to that the reference's run-time switches:
metrics (``aux["metrics"]``), trace spans, elastic participation, the
non-finite guard, a fault plan, ``donate`` (the step writes the new
state into the input state's tensors; the caller drops the old state)
and ``resync`` (the desynchronized-worker rejoin, §13).

One rank holds every worker: a group must have world size 1 for now
(ROADMAP Queue 1 item 7 spreads the worker axis over ranks). Each
all-gather the hooks make is recorded in ``Trainer.gathered`` and each
broadcast in ``Trainer.broadcast_bytes`` (their bytes, in order), which
``Trainer.wire_budget()`` says in advance.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core.muon import EF21Muon, EF21MuonConfig, WireBudget
from repro_torch.device import resolve_device
from repro_torch.dist.layerwise import leaf_paths, tree_leaves, tree_unflatten
from repro_torch.models.api import abstract_params

# all_gather_single is the newer name of all_gather_into_tensor (same
# arguments); the older torch on some installations has only the latter
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@dataclass
class TrainerConfig:
    n_workers: int = 1
    beta: float = 0.1
    w2s: str = "identity"
    s2w: str = "identity"
    wire_pack: bool = True  # fused uint8 payload buffer (needs a group)
    wire_stages: Any = "auto"  # staged wire pipeline (§8): "auto" = one
                               # stage per NS bucket + eager chunk; 1 =
                               # the monolithic single-gather A/B arm
    wire_pack_s2w: Any = "auto"  # pack the s2w model update (§9); "auto"
                                 # follows wire_pack
    metrics: bool = False      # MetricSet in aux["metrics"] (§10)
    trace_spans: bool = False  # record_function/NVTX around the phases
                               # and wire stages (§10)
    participation: Any = "full"  # elastic participation (§11): "full" |
                                 # "bernoulli(p)" | "round_robin(k)" |
                                 # dist.participation.Explicit
    participation_seed: int = 0  # seeds bernoulli participation
    nonfinite_guard: Any = "auto"  # payload finiteness guard (§11):
                                   # "auto" = on iff participation is
                                   # elastic or faults are declared
    faults: Any = None         # train.faults.FaultPlan (§11); forces the
                               # guard on
    donate: bool = False       # in-place state updates: the caller must
                               # not use a state it passed in again
    resync: Any = None         # desynchronized-worker rejoin (§13):
                               # None/0 off; R >= 1 keeps per-worker W_j
                               # and an R-deep replay ring of s2w rounds


def _map_tensors(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tensors(fn, v) for v in tree]
    return tree


class Trainer:
    def __init__(self, model, tcfg: TrainerConfig,
                 device: str | torch.device = "cuda", group=None):
        if group is not None and group.size() != 1:
            raise NotImplementedError(
                f"a process group of {group.size()} ranks: the port holds "
                "every worker on one rank so far; spreading them over "
                "ranks is ROADMAP Queue 1 item 7")
        self.model = model
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.group = group
        self.gathered: list[int] = []   # bytes of each all-gather, in order
        self.broadcast_bytes: list[int] = []   # bytes of each broadcast
        guard = tcfg.nonfinite_guard
        if guard == "auto":
            # chaos implies the guard: declared faults or an elastic
            # schedule turn it on; the plain arm stays bit-equal (§11)
            guard = tcfg.faults is not None or tcfg.participation != "full"
        self.opt = EF21Muon(EF21MuonConfig(
            n_workers=tcfg.n_workers, beta=tcfg.beta, w2s=tcfg.w2s,
            s2w=tcfg.s2w, wire_pack=tcfg.wire_pack,
            wire_stages=tcfg.wire_stages, wire_pack_s2w=tcfg.wire_pack_s2w,
            metrics=tcfg.metrics, trace_spans=tcfg.trace_spans,
            participation=tcfg.participation,
            participation_seed=tcfg.participation_seed,
            nonfinite_guard=bool(guard), resync=tcfg.resync))
        # metas are static: build once from the model's abstract init
        self._params_shapes, self.metas = abstract_params(model)

    def init(self, seed: int) -> dict:
        """Fresh params from ``seed`` and the optimizer state around them.
        With ``donate``, tensors that share memory (tied leaves) are
        copied apart, as the reference's ``_dedup`` does: an in-place
        update of one must not move the other."""
        gen = torch.Generator().manual_seed(seed)
        params, _ = self.model.init(gen, self.device)
        state = self.opt.init(gen, params, self.metas)
        if self.tcfg.donate:
            seen: set = set()

            def dedup(t: torch.Tensor) -> torch.Tensor:
                ptr = t.untyped_storage().data_ptr()
                if ptr in seen:
                    return t.clone()
                seen.add(ptr)
                return t

            state = _map_tensors(dedup, state)
        return state

    def layer_plan(self):
        """The optimizer's LayerPlan for this model — per-leaf
        compressors, the w2s wire bytes (Table 2) and the wire layout."""
        return self.opt.plan(self._params_shapes, self.metas)

    def wire_budget(self) -> WireBudget:
        """What one step's hooks move: ``gathered`` grows by ``n_workers *
        s`` for each ``s`` in ``w2s_sizes``, and ``broadcast_bytes`` by
        ``s2w_sizes`` in ``s2w_issue_order``, per step."""
        return self.opt.wire_budget(self._params_shapes, self.metas,
                                    distributed=self.group is not None)

    def _grad_and_loss(self, params: dict, batch_slice: dict):
        paths = leaf_paths(params)
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            loss = self.model.loss(tree_unflatten(paths, leaves),
                                   batch_slice)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(paths, list(grads))

    def _gather(self, tree: Any) -> Any:
        """The worker->server hook: all-gather every tensor of ``tree``
        (a wire buffer, or per-leaf payloads without the wire) over the
        group along its leading (worker) dim."""
        def one(x: torch.Tensor) -> torch.Tensor:
            x = x.contiguous()
            out = torch.empty((self.group.size() * x.shape[0],)
                              + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            _all_gather(out, x, group=self.group)
            self.gathered.append(x.numel() * x.element_size())
            return out

        return _map_tensors(one, tree)

    def _broadcast(self, buf: torch.Tensor) -> torch.Tensor:
        """The server->worker hook: broadcast the ``[1, nbytes]`` uint8 s2w
        (stage) buffer from the group's rank 0 to every rank, in place.
        The server sends one message, so every link moves exactly the
        buffer's bytes."""
        if buf.dtype != torch.uint8 or buf.ndim != 2 or buf.shape[0] != 1:
            raise ValueError(f"the s2w broadcast takes a [1, nbytes] uint8 "
                             f"buffer, got {buf.dtype} {tuple(buf.shape)}")
        dist.broadcast(buf, src=dist.get_global_rank(self.group, 0),
                       group=self.group)
        self.broadcast_bytes.append(buf.numel())
        return buf

    def make_step(self) -> Callable:
        """Returns step(state, batch, t) -> (state, aux)."""
        grouped = self.group is not None
        opt_step = self.opt.make_step(
            self.metas,
            reshard_payloads=self._gather if grouped else None,
            reshard_updates=self._broadcast if grouped else None,
            faults=self.tcfg.faults, donate=self.tcfg.donate)

        def step(state: dict, batch: Any, t):
            return opt_step(state, self._grad_and_loss, batch, t)

        return step
