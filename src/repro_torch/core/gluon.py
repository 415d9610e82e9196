"""Reference (uncompressed, single-node) Gluon / Muon / Scion (§B.1).

Port of ``repro/core/gluon.py``, the LMO-based family the paper builds
on:

    M_i <- (1 - beta) M_i + beta G_i
    X_i <- X_i + t_i * LMO_{B(0,1)}(M_i)          (eq. (7))

It is the uncompressed baseline of the paper's experiments and the
ground truth of the exact-recovery property: EF21-Muon with identity
compressors on one worker reproduces these iterates. Spectral LMOs on
the hidden layers make it Muon (the Newton-Schulz kernels on the card),
sign LMOs on embedding-like layers Scion, any per-layer norms Gluon.
Params, grads and metas are nested dicts of one structure; the moments
are f32.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.dist.layerwise import (leaf_paths, per_slice, tree_leaves,
                                        tree_unflatten)

from .lmo import lmo_direction


def gluon_init(params: Any) -> dict:
    paths = leaf_paths(params)
    return {"step": 0, "m": tree_unflatten(paths, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in tree_leaves(params)])}


def gluon_update(params: Any, grads: Any, opt_state: dict, metas: Any,
                 t, beta: float = 0.1, ns_steps: int = 5
                 ) -> tuple[Any, dict]:
    """One Gluon step; returns (new_params, new_opt_state)."""
    paths = leaf_paths(params)
    m_new = [(1.0 - beta) * m + beta * g.to(torch.float32)
             for m, g in zip(tree_leaves(opt_state["m"]), tree_leaves(grads))]
    new_params = []
    for x, m, meta in zip(tree_leaves(params), m_new, tree_leaves(metas)):
        radius = torch.as_tensor(t, dtype=torch.float32,
                                 device=x.device) * meta.radius_scale

        def upd(x, g, meta=meta, radius=radius):
            d = lmo_direction(g, meta.lmo, ns_steps=ns_steps)
            return (x.to(torch.float32)
                    + radius * d.to(torch.float32)).to(x.dtype)

        new_params.append(per_slice(upd, meta.stack_dims, x, m))
    return tree_unflatten(paths, new_params), {
        "step": opt_state["step"] + 1, "m": tree_unflatten(paths, m_new)}
