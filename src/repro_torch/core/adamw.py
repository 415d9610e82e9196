"""Minimal AdamW, the baseline optimizer the paper's family replaces and
the usual choice for non-hidden layers in Muon deployments (paper
footnote 2). Port of ``repro/core/adamw.py``: plain functions on nested
dicts of tensors, f32 moments."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.dist.layerwise import leaf_paths, tree_leaves, tree_unflatten


def adamw_init(params: Any) -> dict:
    paths, leaves = leaf_paths(params), tree_leaves(params)

    def zeros():
        return tree_unflatten(paths, [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves])

    return {"step": 0, "mu": zeros(), "nu": zeros()}


def adamw_update(params: Any, grads: Any, state: dict, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0) -> tuple[Any, dict]:
    """One AdamW step; returns (new_params, new_state)."""
    paths = leaf_paths(params)
    step = state["step"] + 1
    g_l = [g.to(torch.float32) for g in tree_leaves(grads)]
    mu = [b1 * m + (1 - b1) * g for m, g in zip(tree_leaves(state["mu"]), g_l)]
    nu = [b2 * v + (1 - b2) * torch.square(g)
          for v, g in zip(tree_leaves(state["nu"]), g_l)]
    new = []
    for p, m, v in zip(tree_leaves(params), mu, nu):
        t = torch.tensor(step, dtype=torch.float32, device=p.device)
        lr_t = torch.tensor(lr, dtype=torch.float32, device=p.device)
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        upd = lr_t * (mhat / (torch.sqrt(vhat) + eps)
                      + weight_decay * p.to(torch.float32))
        new.append((p.to(torch.float32) - upd).to(p.dtype))
    return tree_unflatten(paths, new), {
        "step": step, "mu": tree_unflatten(paths, mu),
        "nu": tree_unflatten(paths, nu)}
