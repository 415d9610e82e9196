"""Radius schedule: Karpathy's nanoGPT scheduler (linear warmup, then
linear decay), as the paper uses. Port of
``repro/core/schedule.py::warmup_linear_decay``; the arithmetic is in
float32, as the reference's is, so both give the same radii."""
from __future__ import annotations

import numpy as np


def warmup_linear_decay(t0: float, warmup: int, total: int,
                        final_frac: float = 0.1):
    """step -> radius (a float32 scalar): linear warmup over ``warmup``
    steps, then linear decay to ``final_frac * t0`` at ``total``."""
    def fn(step) -> np.float32:
        step = np.float32(step)
        w = np.float32(max(warmup, 1))
        if step < w:
            return np.float32(t0) * (step / w)
        frac = np.clip((step - w) / np.float32(max(total - warmup, 1)),
                       np.float32(0.0), np.float32(1.0))
        return np.float32(t0) * (np.float32(1.0)
                                 - np.float32(1.0 - final_frac) * frac)
    return fn
