"""Model API of the port.

    model = build_model(cfg)
    params, metas = model.init(generator, device)
    loss = model.loss(params, batch)
    cache = model.init_cache(batch_size, max_len, device)
    logits, cache = model.prefill(params, batch, cache)
    logits, cache = model.decode_step(params, batch, cache)

Shape kinds (``input_specs``): ``train`` -> {"tokens", "labels"} with a
leading ``[n_workers, batch / n_workers]`` pair of dims; ``prefill`` ->
{"tokens"} with a leading ``[batch]``; ``decode`` -> {"token": [B, 1],
"t": []} consumed together with a cache of length ``seq`` (the shape's
seq is the cache's length).

``params_from_jax`` carries the reference's parameters (as a tree of
numpy arrays) into the port, and ``state_from_jax`` its whole EF21-Muon
state, and ``cache_from_jax`` its decode cache, for parity checks
against ``repro`` from one starting point;
``state_to_numpy`` is the way back, the reference's layout of the state,
which ``train/checkpoint.py`` writes. On a process group (the worker
axis, ``dist/sharding.py``) ``state_from_jax`` gives a rank its slice of
the workers' leaves and ``state_to_numpy`` gathers them to rank 0.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec


def build_model(cfg: ArchConfig):
    if cfg.family in ("dense", "moe"):
        from .transformer import Transformer
        return Transformer(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported to repro_torch yet: ROADMAP "
        "Queue 1 item 9 (the other model families)")


def abstract_params(model) -> tuple:
    """(params on the meta device, metas) from ``model.init`` without
    allocating memory or drawing random numbers."""
    return model.init(None, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                n_workers: int = 1) -> dict:
    """Every model input of ``shape``'s kind as a meta tensor (shape and
    dtype, no memory), as the reference's ``input_specs``. For a decode
    kind the cache is an input too: ``build_model(cfg).cache_spec(
    shape.batch, shape.seq)``."""
    s, b = shape.seq, shape.batch

    def spec(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind == "train":
        if b % n_workers:
            raise ValueError(f"batch {b} does not split over {n_workers} "
                             "workers")
        lead = (n_workers, b // n_workers)
        return {"tokens": spec(*lead, s), "labels": spec(*lead, s)}
    if shape.kind == "prefill":
        return {"tokens": spec(b, s)}
    if shape.kind == "decode":
        return {"token": spec(b, 1), "t": spec()}
    raise ValueError(shape.kind)


def make_batch(cfg: ArchConfig, shape: ShapeSpec,
               generator: torch.Generator, n_workers: int = 1,
               device: str | torch.device = "cuda") -> dict:
    """A random batch matching ``input_specs``: tokens uniform over the
    vocabulary drawn from ``generator`` on its device, in the specs'
    order, then moved to ``device``; a decode batch's ``t`` is
    ``seq - 1``."""
    out = {}
    for name, s in input_specs(cfg, shape, n_workers).items():
        if name == "t":
            out[name] = torch.tensor(shape.seq - 1, dtype=torch.int32)
            continue
        out[name] = torch.randint(0, cfg.vocab, tuple(s.shape),
                                  generator=generator, dtype=s.dtype,
                                  device=generator.device).to(device)
    return out


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


def cache_from_jax(tree: Any, device: str | torch.device = "cpu") -> Any:
    """The reference's decode cache (``jax.tree.map(np.asarray, cache)``:
    ``{stack: {"k", "v"}}`` of ``[L, B, cap, KVH, hd]``, or with MLA
    ``{stack: {"c_kv": [L, B, cap, kv_lora], "k_rope": [L, B, cap,
    qk_rope]}}``) as the port's, value for value and dtype for dtype,
    ring slots where they are."""
    return params_from_jax(tree, device)


# keys of the reference's EF21-Muon state that the port's step runs
_STATE_TREES = ("x", "g_server", "g_w", "m_w", "w", "w_w", "resync")
_STATE_LISTS = ("cw_state", "cs_state")     # per leaf, in leaf order


def state_from_jax(jstate: dict, device: str | torch.device = "cpu",
                   group=None) -> dict:
    """The reference's EF21-Muon state (``jax.tree.map(np.asarray,
    state)``) as the port's: the same tensors value for value and dtype
    for dtype, the step as an int, and the compressor states, which the
    reference keeps as trees shaped like the params, as per-leaf lists in
    the params' leaf order (RankK's ``{"q": ...}``, bf16 bits
    ``[n_workers, *stack, n, r]`` in ``cw_state`` and ``[*stack, n, r]``
    in ``cs_state``; ``{}`` for the compressors that keep none). The
    resync state comes as it is: ``w_w`` a tree like the params with the
    workers leading, ``resync`` the version vector ``vv`` (int32) and
    the ring (uint8). A key that is no part of an EF21-Muon state
    raises. With ``group`` the worker-lead leaves (``g_w``, ``m_w``,
    ``cw_state``, ``w_w``) keep this rank's workers' rows, sliced before
    they reach ``device``."""
    from repro_torch.dist.layerwise import leaf_paths, tree_get
    unknown = set(jstate) - {"step", *_STATE_TREES, *_STATE_LISTS}
    if unknown:
        raise ValueError(
            f"state keys {sorted(unknown)} are no part of an EF21-Muon "
            "state")
    if group is not None and group.size() > 1:
        from repro_torch.dist.sharding import local_workers, worker_lead_paths
        n = _lead_rows(jstate["g_w"])
        rows = local_workers(group, n)
        jstate = dict(jstate)
        for key in worker_lead_paths(jstate):
            jstate[key] = _rows_of(jstate[key], rows)
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


def _lead_rows(tree: Any) -> int:
    """The leading dim of a tree's first array (the worker count)."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(np.shape(tree)[0])


def _rows_of(tree: Any, rows: range) -> Any:
    """Rows ``rows`` of every array of a tree (numpy views)."""
    if isinstance(tree, dict):
        return {k: _rows_of(v, rows) for k, v in tree.items()}
    if tree is None:
        return None
    return np.asarray(tree)[rows.start:rows.stop]


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


def state_to_numpy(state: dict, like: Any = None, group=None,
                   record: list | None = None) -> dict | None:
    """The inverse of ``state_from_jax``: the state in the reference's
    layout (``state_layout``) as numpy arrays, one device-to-host copy
    per tensor, bf16 as its 2-byte patterns (a ``V2`` array, which
    ``state_from_jax`` reads back bit for bit). On a group of several
    ranks every rank takes part in gathering the worker-lead leaves
    (``record`` gets each gather's bytes) and rank 0 gets the one-rank
    state; the other ranks get None."""
    if group is not None and group.size() > 1:
        import torch.distributed as dist
        from repro_torch.dist.sharding import gather_state
        state = gather_state(state, group, record)
        if dist.get_rank(group) != 0:
            return None
    return _numpy(state_layout(state, like))
