"""Norms and dual norms on matrix/vector spaces (paper §1.1, §B).

Port of ``repro/core/norms.py``. Each norm is identified by a string
key; ``DUAL[key]`` names its dual.
"""
from __future__ import annotations

import math

import torch

# primal -> dual
DUAL = {
    "spectral": "nuclear",
    "nuclear": "spectral",
    "frobenius": "frobenius",
    "linf": "l1",
    "l1": "linf",
    "col_l2": "col_l2_dual",      # max column l2; dual = sum of column l2
    "col_l2_dual": "col_l2",
    "row_l2": "row_l2_dual",      # max row l2; dual = sum of row l2
    "row_l2_dual": "row_l2",
}


def _svals(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.svdvals(x.reshape(x.shape[0], -1) if x.ndim > 2
                                else x)


def norm(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Evaluate ||x||_kind. 1-D inputs take vector norms; spectral and
    nuclear flatten higher-rank inputs to 2-D on the trailing axes."""
    if kind == "frobenius":
        return torch.sqrt(torch.sum(torch.square(x.to(torch.float32))))
    if kind == "linf":
        return torch.max(torch.abs(x))
    if kind == "l1":
        return torch.sum(torch.abs(x))
    if kind == "spectral":
        if x.ndim < 2:
            return torch.max(torch.abs(x))
        return torch.max(_svals(x.to(torch.float32)))
    if kind == "nuclear":
        if x.ndim < 2:
            return torch.sum(torch.abs(x))
        return torch.sum(_svals(x.to(torch.float32)))
    x2 = x.to(torch.float32)
    if kind == "col_l2":
        return torch.max(torch.sqrt(torch.sum(torch.square(x2), dim=0)))
    if kind == "col_l2_dual":
        return torch.sum(torch.sqrt(torch.sum(torch.square(x2), dim=0)))
    if kind == "row_l2":
        return torch.max(torch.sqrt(torch.sum(torch.square(x2), dim=1)))
    if kind == "row_l2_dual":
        return torch.sum(torch.sqrt(torch.sum(torch.square(x2), dim=1)))
    raise ValueError(f"unknown norm kind: {kind}")


def dual_norm(x: torch.Tensor, kind: str) -> torch.Tensor:
    """||x||_* where * is the dual of ``kind``."""
    return norm(x, DUAL[kind])


def norm_equivalence_constants(shape: tuple[int, ...],
                               kind: str) -> tuple[float, float]:
    """(rho_lo, rho_hi) with rho_lo ||X||_kind <= ||X||_2 <= rho_hi
    ||X||_kind (Remark 7: spectral has rho_lo = 1, rho_hi = sqrt(rank))."""
    n = math.prod(shape)
    if kind == "frobenius":
        return 1.0, 1.0
    if kind == "spectral":
        r = min(shape) if len(shape) >= 2 else 1
        return 1.0, math.sqrt(r)
    if kind == "linf":
        return 1.0, math.sqrt(n)
    if kind == "l1":
        return 1.0 / math.sqrt(n), 1.0
    if kind == "col_l2":
        c = shape[-1] if len(shape) >= 2 else 1
        return 1.0, math.sqrt(c)
    if kind == "row_l2":
        r = shape[0] if len(shape) >= 2 else 1
        return 1.0, math.sqrt(r)
    raise ValueError(f"no equivalence constants for {kind}")
