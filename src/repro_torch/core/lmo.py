"""Linear minimization oracles over norm balls and sharp operators (§2, §C).

Port of ``repro/core/lmo.py``. Conventions:
  * ``lmo_direction(g, kind)`` returns Z* = argmin_{||Z|| <= 1} <g, Z>,
    so <g, Z*> = -||g||_* and ||Z*|| = 1.
  * ``sharp(g, kind)`` returns g# = -||g||_* * lmo_direction(g).
  * the optimizer step is X <- X + t * lmo_direction(G).

Norm kinds: spectral (-UV^T by Newton-Schulz, the Hopper kernels), sign
(l_inf), col_l2, row_l2, euclid (Frobenius), nuclear (rank-1 power
iteration).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import newton_schulz, newton_schulz_batched

EPS = 1e-12

SUPPORTED = ("spectral", "sign", "col_l2", "row_l2", "euclid", "nuclear")

# LMO kind -> the norm whose unit ball it minimises over
BALL_NORM = {"spectral": "spectral", "sign": "linf", "euclid": "frobenius",
             "col_l2": "col_l2", "row_l2": "row_l2", "nuclear": "nuclear"}


def _power_iteration_rank1(g: torch.Tensor, iters: int = 12):
    """Top singular triple (sigma, u, v) of a 2-D matrix by power
    iteration (deterministic start: leading column-abs-sum vector)."""
    gf = g.to(torch.float32)
    v = torch.sum(torch.abs(gf), dim=0) + 1e-3
    v = v / (torch.linalg.norm(v) + EPS)
    for _ in range(iters):
        u = gf @ v
        u = u / (torch.linalg.norm(u) + EPS)
        v = gf.T @ u
        v = v / (torch.linalg.norm(v) + EPS)
    u = gf @ v
    s = torch.linalg.norm(u)
    return s, u / (s + EPS), v


def lmo_direction(g: torch.Tensor, kind: str, *,
                  ns_steps: int = 5) -> torch.Tensor:
    """Z* = argmin_{||Z||_kind <= 1} <g, Z> on one slice."""
    if kind == "spectral":
        if g.ndim != 2:
            raise ValueError("spectral LMO needs a 2-D matrix")
        return -newton_schulz(g, steps=ns_steps)
    if kind == "sign":
        return -torch.sign(g)
    gf = g.to(torch.float32)
    if kind == "euclid":
        return (-gf / (torch.linalg.norm(gf) + EPS)).to(g.dtype)
    if kind == "col_l2":
        col = torch.sqrt(torch.sum(torch.square(gf), dim=0, keepdim=True))
        return (-gf / (col + EPS)).to(g.dtype)
    if kind == "row_l2":
        row = torch.sqrt(torch.sum(torch.square(gf), dim=1, keepdim=True))
        return (-gf / (row + EPS)).to(g.dtype)
    if kind == "nuclear":
        _, u, v = _power_iteration_rank1(g)
        return (-torch.outer(u, v)).to(g.dtype)
    raise ValueError(f"unknown LMO kind: {kind}")


def lmo_direction_batched(g: torch.Tensor, kind: str = "spectral", *,
                          ns_steps: int = 5) -> torch.Tensor:
    """Batched spectral Z* over a ``[B, m, n]`` canonical slice stack
    (m <= n, orientation fixed by ``repro_torch.dist.bucketing``)."""
    if kind != "spectral":
        raise ValueError(f"batched LMO supports 'spectral' only, got {kind}")
    if g.ndim != 3:
        raise ValueError("batched spectral LMO needs a [B, m, n] stack")
    return -newton_schulz_batched(g, steps=ns_steps)


def sharp(g: torch.Tensor, kind: str, **kw) -> torch.Tensor:
    """g# = argmax_X {<g, X> - ||X||^2/2} = -||g||_* LMO_{B(0,1)}(g)."""
    from .norms import dual_norm
    d = lmo_direction(g, kind, **kw)
    return (-dual_norm(g, BALL_NORM[kind])
            * d.to(torch.float32)).to(g.dtype)


def default_radius_scale(shape: tuple[int, ...], kind: str) -> float:
    """Muon-style per-layer radius scaling: sqrt(max(1, out/in)) for
    spectral matrices (out = shape[-1] in the [in, out] layout), 1.0
    otherwise."""
    if kind == "spectral" and len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
        return max(1.0, fan_out / max(fan_in, 1)) ** 0.5
    return 1.0
