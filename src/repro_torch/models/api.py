"""Model API of the port.

    model = build_model(cfg)
    params, metas = model.init(generator, device)
    loss = model.loss(params, batch)

``params_from_jax`` carries the reference's parameters (as a tree of
numpy arrays) into the port, and ``state_from_jax`` its whole EF21-Muon
state, for parity checks against ``repro`` from one starting point;
``state_to_numpy`` is the way back, the reference's layout of the state,
which ``train/checkpoint.py`` writes.
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


def array_to_tensor(x: Any, device) -> torch.Tensor:
    """An array as a tensor on ``device``, value for value. bf16 comes as
    ``ml_dtypes``' bfloat16 (as JAX exports it) or as its 2-byte patterns
    (a ``V2`` array: numpy without ``ml_dtypes``, or ``np.load`` of the
    reference's checkpoint); both keep their bits."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
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
    return array_to_tensor(tree, device)


# keys of the reference's EF21-Muon state that the port's step runs
_STATE_TREES = ("x", "g_server", "g_w", "m_w", "w")
_STATE_LISTS = ("cw_state", "cs_state")     # per leaf, in leaf order


def state_from_jax(jstate: dict, device: str | torch.device = "cpu") -> dict:
    """The reference's EF21-Muon state (``jax.tree.map(np.asarray,
    state)``) as the port's: the same tensors value for value and dtype
    for dtype, the step as an int, and the compressor states, which the
    reference keeps as trees shaped like the params, as per-leaf lists in
    the params' leaf order (RankK's ``{"q": ...}``, bf16 bits
    ``[n_workers, *stack, n, r]`` in ``cw_state`` and ``[*stack, n, r]``
    in ``cs_state``; ``{}`` for the compressors that keep none). Keys the
    port's step does not run (the resync state, ROADMAP Queue 1 item 8)
    raise."""
    from repro_torch.dist.layerwise import leaf_paths, tree_get
    unknown = set(jstate) - {"step", *_STATE_TREES, *_STATE_LISTS}
    if unknown:
        raise NotImplementedError(
            f"state keys {sorted(unknown)} are not ported to repro_torch "
            "yet: ROADMAP Queue 1 item 8 (resync)")
    paths = leaf_paths(jstate["x"])
    out: dict = {"step": int(np.asarray(jstate["step"]))}
    for key in _STATE_TREES:
        if key in jstate:
            out[key] = (None if jstate[key] is None
                        else params_from_jax(jstate[key], device))
    for key in _STATE_LISTS:
        if key in jstate:
            out[key] = [params_from_jax(tree_get(jstate[key], p), device)
                        for p in paths]
    return out


def state_layout(state: dict, like: Any = None) -> dict:
    """The port's EF21-Muon state in the reference's layout, its tensors
    untouched: the compressor-state lists as trees shaped like ``like``
    (the params; default ``state["x"]``), ``{}`` where a compressor keeps
    no state, and the step as an int32 scalar."""
    from repro_torch.dist.layerwise import leaf_paths, tree_unflatten
    paths = leaf_paths(state["x"] if like is None else like)
    out: dict = {"step": np.asarray(state["step"], dtype=np.int32)}
    for key in _STATE_TREES:
        if key in state:
            out[key] = state[key]
    for key in _STATE_LISTS:
        if key in state:
            out[key] = tree_unflatten(
                paths, [{} if cs is None else cs for cs in state[key]])
    return out


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host through one device-to-host copy; bf16 as its
    2-byte patterns (a ``V2`` array: no ``ml_dtypes`` needed)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.dtype("V2"))
    return t.cpu().numpy()


def _numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tensor_to_array(tree) if isinstance(tree, torch.Tensor) else tree


def state_to_numpy(state: dict, like: Any = None) -> dict:
    """The inverse of ``state_from_jax``: the state in the reference's
    layout (``state_layout``) as numpy arrays, one device-to-host copy
    per tensor, bf16 as its 2-byte patterns (a ``V2`` array, which
    ``state_from_jax`` reads back bit for bit)."""
    return _numpy(state_layout(state, like))
