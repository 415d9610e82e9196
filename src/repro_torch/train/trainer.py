"""EF21-Muon trainer on one process.

Port of ``repro/train/trainer.py`` for the single-process path (the
reference's ``mesh=None``): model loss, the EF21Muon optimizer, and the
per-worker gradient function. The dataflow per step (DESIGN.md §5) with
the identity server->worker leg and no collective:

  2. per-worker grads at W = X, one autograd pass per worker;
  3. per-worker momentum + EF21 compress: R_j = C_D(M_j - G_j);
  4. server fold: G += mean_j decompress(R_j);
  5. X = LMO_B(X, t)(G), the spectral leaves through the batched
     Newton-Schulz chain (the CUDA kernels on the card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.muon import EF21Muon, EF21MuonConfig
from repro_torch.device import resolve_device
from repro_torch.dist.layerwise import leaf_paths, tree_leaves, tree_unflatten
from repro_torch.models.api import abstract_params


@dataclass
class TrainerConfig:
    n_workers: int = 1
    beta: float = 0.1
    w2s: str = "identity"
    s2w: str = "identity"   # only "identity" runs (ROADMAP Queue 1 item 4)


class Trainer:
    def __init__(self, model, tcfg: TrainerConfig,
                 device: str | torch.device = "cuda"):
        self.model = model
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.opt = EF21Muon(EF21MuonConfig(
            n_workers=tcfg.n_workers, beta=tcfg.beta, w2s=tcfg.w2s,
            s2w=tcfg.s2w))
        # metas are static: build once from the model's abstract init
        self._params_shapes, self.metas = abstract_params(model)

    def init(self, seed: int) -> dict:
        """Fresh params from ``seed`` and the optimizer state around them."""
        gen = torch.Generator().manual_seed(seed)
        params, _ = self.model.init(gen, self.device)
        return self.opt.init(gen, params, self.metas)

    def layer_plan(self):
        """The optimizer's LayerPlan for this model — per-leaf
        compressors and the w2s wire bytes (Table 2)."""
        return self.opt.plan(self._params_shapes, self.metas)

    def _grad_and_loss(self, params: dict, batch_slice: dict):
        paths = leaf_paths(params)
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            loss = self.model.loss(tree_unflatten(paths, leaves),
                                   batch_slice)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(paths, list(grads))

    def make_step(self) -> Callable:
        """Returns step(state, batch, t) -> (state, aux)."""
        opt_step = self.opt.make_step(self.metas)

        def step(state: dict, batch: Any, t):
            return opt_step(state, self._grad_and_loss, batch, t)

        return step
