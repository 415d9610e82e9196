"""EF21-Muon trainer.

Port of ``repro/train/trainer.py``: model loss, the EF21Muon optimizer,
the per-worker gradient function and, with a ``torch.distributed``
process group (the counterpart of the reference's mesh), the
worker->server communication hook. The dataflow per step (DESIGN.md §5)
with the identity server->worker leg:

  2. per-worker grads at W = X, one autograd pass per worker;
  3. per-worker momentum + EF21 compress: R_j = C_D(M_j - G_j);
  4. with a group, the payloads packed into uint8 wire buffers
     (``repro_torch.wire``; one per wire stage) and each all-gathered
     over the group; without one, nothing is packed;
  5. server fold G += mean_j decompress(R_j), then X = LMO_B(X, t)(G),
     the spectral leaves through the batched Newton-Schulz chain (the
     CUDA kernels on the card).

One rank holds every worker: a group must have world size 1 for now
(ROADMAP Queue 1 item 7 spreads the worker axis over ranks). Each
all-gather the hook makes is recorded in ``Trainer.gathered`` (its bytes),
which ``Trainer.wire_budget()`` says in advance.
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
    s2w: str = "identity"   # only "identity" runs (ROADMAP Queue 1 item 4)
    wire_pack: bool = True  # fused uint8 payload buffer (needs a group)
    wire_stages: Any = "auto"  # staged wire pipeline (§8): "auto" = one
                               # stage per NS bucket + eager chunk; 1 =
                               # the monolithic single-gather A/B arm


def _map_tensors(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return [_map_tensors(fn, v) for v in tree]


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
        self.opt = EF21Muon(EF21MuonConfig(
            n_workers=tcfg.n_workers, beta=tcfg.beta, w2s=tcfg.w2s,
            s2w=tcfg.s2w, wire_pack=tcfg.wire_pack,
            wire_stages=tcfg.wire_stages))
        # metas are static: build once from the model's abstract init
        self._params_shapes, self.metas = abstract_params(model)

    def init(self, seed: int) -> dict:
        """Fresh params from ``seed`` and the optimizer state around them."""
        gen = torch.Generator().manual_seed(seed)
        params, _ = self.model.init(gen, self.device)
        return self.opt.init(gen, params, self.metas)

    def layer_plan(self):
        """The optimizer's LayerPlan for this model — per-leaf
        compressors, the w2s wire bytes (Table 2) and the wire layout."""
        return self.opt.plan(self._params_shapes, self.metas)

    def wire_budget(self) -> WireBudget:
        """What one step's hook gathers: ``gathered`` grows by
        ``n_workers * s`` for each ``s`` in ``w2s_sizes`` per step."""
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

    def make_step(self) -> Callable:
        """Returns step(state, batch, t) -> (state, aux)."""
        opt_step = self.opt.make_step(
            self.metas,
            reshard_payloads=None if self.group is None else self._gather)

        def step(state: dict, batch: Any, t):
            return opt_step(state, self._grad_and_loss, batch, t)

        return step
