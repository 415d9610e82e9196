"""Model API of the port.

    model = build_model(cfg)
    params, metas = model.init(generator, device)
    loss = model.loss(params, batch)

``params_from_jax`` carries the reference's parameters (as a tree of
numpy arrays) into the port, for parity checks against ``repro``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def build_model(cfg: ArchConfig):
    if cfg.family == "dense":
        from .transformer import Transformer
        return Transformer(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported to repro_torch yet: ROADMAP "
        "Queue 1 item 9 (the rest of the model zoo)")


def abstract_params(model) -> tuple:
    """(params on the meta device, metas) from ``model.init`` without
    allocating memory or drawing random numbers."""
    return model.init(None, device="meta")


def _to_tensor(x: Any, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":   # ml_dtypes bfloat16, as JAX exports it
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(tree: Any, device: str | torch.device = "cpu") -> Any:
    """A nested dict of arrays (the reference's params after
    ``jax.tree.map(np.asarray, params)``) as the same nested dict of
    tensors on ``device``, value for value and dtype for dtype. The
    layout is the reference's: weights [in, out], layers stacked."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _to_tensor(tree, device)
