"""Radius schedules. The paper adopts Karpathy's nanoGPT scheduler
(linear warmup, then linear decay); beside it the theory-facing radius
eta / sqrt(K+1) of Theorems 4/17, a constant one and a cosine decay.
Port of ``repro/core/schedule.py``; the arithmetic is in float32, as the
reference's is, so both give the same radii."""
from __future__ import annotations

import numpy as np

_F = np.float32


def constant(t0: float):
    """step -> ``t0`` (a float32 scalar)."""
    return lambda step: _F(t0)


def theory_radius(eta: float, total_steps: int):
    """t^k = eta / sqrt(K+1): radii free of problem constants (Thm 4/17)."""
    val = eta / (total_steps + 1) ** 0.5
    return lambda step: _F(val)


def warmup_linear_decay(t0: float, warmup: int, total: int,
                        final_frac: float = 0.1):
    """step -> radius (a float32 scalar): linear warmup over ``warmup``
    steps, then linear decay to ``final_frac * t0`` at ``total``."""
    def fn(step) -> np.float32:
        step = _F(step)
        w = _F(max(warmup, 1))
        if step < w:
            return _F(t0) * (step / w)
        frac = np.clip((step - w) / _F(max(total - warmup, 1)), _F(0.0),
                       _F(1.0))
        return _F(t0) * (_F(1.0) - _F(1.0 - final_frac) * frac)
    return fn


def cosine(t0: float, warmup: int, total: int, final_frac: float = 0.0):
    """step -> radius (a float32 scalar): linear warmup over ``warmup``
    steps, then a cosine from ``t0`` down to ``final_frac * t0`` at
    ``total``."""
    def fn(step) -> np.float32:
        step = _F(step)
        w = _F(max(warmup, 1))
        if step < w:
            return _F(t0) * (step / w)
        prog = np.clip((step - w) / _F(max(total - warmup, 1)), _F(0.0),
                       _F(1.0))
        # the cosine of the f32 angle, correctly rounded to f32
        c = _F(np.cos(np.float64(_F(np.pi) * prog)))
        cos = _F(final_frac) + _F((1 - final_frac) * 0.5) * (_F(1) + c)
        return _F(t0) * cos
    return fn
