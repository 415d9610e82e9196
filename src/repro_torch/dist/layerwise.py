"""Layer-wise tree plumbing for the EF21-Muon optimizer.

Port of ``repro/dist/layerwise.py`` without its mesh parts. A
``LayerPlan`` precomputes, once per (params shapes, metas), everything
static about each parameter leaf — stack dims, slice shape, the
resolved worker->server compressor — so the optimizer states algorithm
steps instead of tree mechanics, and memoises what is derived from it:
the NS buckets, the staged-wire stage plan and the wire layouts. (The
server->worker compressor joins with the EF21-P leg, ROADMAP Queue 1
item 4.)

Leaf order is ``jax.tree.flatten``'s: dict keys sorted at every level,
depth first. Leaf indices, bucket membership and the concat order inside
a bucket all follow it, so they are the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core.compressors import get_compressor


def leaf_paths(tree: Any, prefix: tuple[str, ...] = ()) -> list[tuple]:
    """Key paths of a nested dict's leaves in ``jax.tree.flatten`` order."""
    if isinstance(tree, dict):
        out: list = []
        for k in sorted(tree):
            out += leaf_paths(tree[k], prefix + (k,))
        return out
    return [prefix]


def _get(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def tree_unflatten(paths: list[tuple], leaves: list) -> dict:
    """Inverse of flattening along ``paths`` (from ``leaf_paths``)."""
    out: dict = {}
    for path, leaf in zip(paths, leaves, strict=True):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


def tree_leaves(tree: Any) -> list:
    return [_get(tree, p) for p in leaf_paths(tree)]


@dataclass(frozen=True)
class LeafPlan:
    """Everything static about one parameter leaf."""
    meta: Any                       # ParamMeta
    shape: tuple[int, ...]          # full leaf shape (no worker dim)
    stack_shape: tuple[int, ...]    # leading stack dims
    slice_shape: tuple[int, ...]    # per-layer operand the LMO/compressor sees
    n_stack: int                    # prod(stack_shape)
    w2s: Any                        # resolved worker->server compressor


class LayerPlan:
    """Per-(shapes, metas) plan shared by every optimizer phase."""

    def __init__(self, paths: list[tuple], leaves: list[LeafPlan]):
        self.paths = paths
        self.leaves = leaves
        self._ns_buckets = None
        self._stage_plans: dict = {}
        self._wire_layouts: dict = {}
        self._staged_layouts: dict = {}

    @classmethod
    def build(cls, params: Any, metas: Any,
              w2s: str = "identity") -> "LayerPlan":
        """``params`` may hold tensors on any device, meta tensors
        included — only ``.shape`` is read. ``metas`` mirrors the params
        tree with ParamMeta leaves; incompressible leaves get the identity
        compressor."""
        paths = leaf_paths(params)
        plans = []
        for path in paths:
            p, m = _get(params, path), _get(metas, path)
            shape = tuple(p.shape)
            stack = shape[:m.stack_dims]
            plans.append(LeafPlan(
                meta=m, shape=shape, stack_shape=stack,
                slice_shape=shape[m.stack_dims:],
                n_stack=int(math.prod(stack)) if stack else 1,
                w2s=get_compressor(w2s if m.compressible else "identity")))
        return cls(paths, plans)

    # ------------------------------------------------------------- tree ops
    def flatten(self, tree: Any) -> list:
        return [_get(tree, p) for p in self.paths]

    def unflatten(self, leaves: list) -> dict:
        return tree_unflatten(self.paths, leaves)

    # ------------------------------------------------------ wire accounting
    def w2s_bytes_per_worker(self, wire_dtype: torch.dtype) -> int:
        """Static bytes of one worker->server message (Table 2): the sum
        over leaves of stack count x per-slice payload bytes."""
        return sum(lp.n_stack * lp.w2s.payload_bytes(lp.slice_shape,
                                                     wire_dtype)
                   for lp in self.leaves)

    def dense_bytes(self, wire_dtype: torch.dtype) -> int:
        """Uncompressed wire cost of the same message."""
        return dense_payload_bytes((lp.shape for lp in self.leaves),
                                   wire_dtype)

    # ------------------------------------------------------- NS bucketing
    def ns_buckets(self) -> tuple:
        """Shape buckets over the spectral leaves — the grouping behind
        the batched Newton-Schulz dispatch of the optimizer's phase 5.
        Built once per plan."""
        if self._ns_buckets is None:
            from repro_torch.dist.bucketing import build_buckets
            self._ns_buckets = build_buckets(self)
        return self._ns_buckets

    # ------------------------------------------------------- wire staging
    def stage_plan(self, wire_stages="auto", ns_steps: int = 5):
        """The staged-wire-pipeline partition of this plan's leaves
        (DESIGN.md §8): stage 0 carries the per-leaf-path (eager) leaves,
        then one stage per NS bucket descending by NS FLOPs, capped at
        ``wire_stages``. Built once per (wire_stages, ns_steps)."""
        from repro_torch.dist.pipeline import build_stage_plan
        key = (wire_stages, ns_steps)
        if key not in self._stage_plans:
            self._stage_plans[key] = build_stage_plan(
                self, self.ns_buckets(), wire_stages=wire_stages,
                ns_steps=ns_steps)
        return self._stage_plans[key]

    def wire_layout(self, wire_dtype: torch.dtype):
        """The static WireLayout (``repro_torch.wire``) of this plan's
        worker->server message, memoised per wire dtype:
        ``total_nbytes`` is exactly what the u8 all-gather moves per
        worker, beside the analytic Table-2 ``w2s_bytes_per_worker``
        (which keeps the paper's 4-byte-index convention)."""
        from repro_torch.wire.layout import build_layout
        if wire_dtype not in self._wire_layouts:
            self._wire_layouts[wire_dtype] = build_layout(self, wire_dtype)
        return self._wire_layouts[wire_dtype]

    def staged_wire_layout(self, wire_dtype: torch.dtype, stage_plan):
        """The ``StagedWireLayout`` cutting ``wire_layout`` along
        ``stage_plan``, memoised per (wire dtype, partition)."""
        from repro_torch.wire.layout import build_staged_layout
        ids = tuple(s.leaf_ids for s in stage_plan.stages)
        key = (wire_dtype, ids)
        if key not in self._staged_layouts:
            self._staged_layouts[key] = build_staged_layout(
                self.wire_layout(wire_dtype), ids)
        return self._staged_layouts[key]


def dense_payload_bytes(shapes, wire_dtype: torch.dtype) -> int:
    """Wire bytes of an uncompressed message over the given leaf shapes."""
    itemsize = torch.empty((), dtype=wire_dtype).element_size()
    return sum(int(math.prod(s)) * itemsize for s in shapes)
