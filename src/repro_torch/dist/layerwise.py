"""Layer-wise tree plumbing for the EF21-Muon optimizer.

Port of ``repro/dist/layerwise.py``. A ``LayerPlan`` precomputes, once per (params shapes, metas), everything
static about each parameter leaf — stack dims, slice shape, the
resolved compressors of both directions (``resolve_compressor``) — so
the optimizer states algorithm steps instead of tree mechanics, and
memoises what is derived from it:
the NS buckets and the staged-wire stage plan (per mesh shape and
``fsdp``, as the reference keys them) and the wire layouts of both
directions (worker->server, ``w2s``; the EF21-P server->worker model
update, ``s2w``).

Leaf order is ``jax.tree.flatten``'s: dict keys sorted at every level,
depth first. Leaf indices, bucket membership and the concat order inside
a bucket all follow it, so they are the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core import compressors as comp_lib
from repro_torch.obs.trace import span


def leaf_paths(tree: Any, prefix: tuple[str, ...] = ()) -> list[tuple]:
    """Key paths of a nested dict's leaves in ``jax.tree.flatten`` order."""
    if isinstance(tree, dict):
        out: list = []
        for k in sorted(tree):
            out += leaf_paths(tree[k], prefix + (k,))
        return out
    return [prefix]


def tree_get(tree: Any, path: tuple) -> Any:
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
    return [tree_get(tree, p) for p in leaf_paths(tree)]


def per_slice(fn: Callable, stack_dims: int, *xs: torch.Tensor
              ) -> torch.Tensor:
    """``fn`` on every slice of the leading ``stack_dims`` dims (the
    reference's ``vmap_n``), results stacked back."""
    if stack_dims == 0:
        return fn(*xs)
    shape = xs[0].shape
    flat = [x.reshape((-1,) + tuple(x.shape[stack_dims:])) for x in xs]
    outs = [fn(*s) for s in zip(*flat)]
    return torch.stack(outs).reshape(shape)


def resolve_compressor(name: str, slice_shape: tuple[int, ...]):
    """The compressor of one leaf slice. Rank-type compressors (RankK,
    TopKSVD, with or without a Natural wrapper) need a matrix slice; on a
    slice that is not 2-D they fall back to ``TopK(0.25)``, keeping the
    Natural wrapper if one was asked for (the reference's rule)."""
    comp = comp_lib.get_compressor(name)
    inner = comp.inner if isinstance(comp, comp_lib.WithNatural) else comp
    if isinstance(inner, (comp_lib.RankK, comp_lib.TopKSVD)) \
            and len(slice_shape) != 2:
        fallback = comp_lib.TopK(0.25)
        if isinstance(comp, comp_lib.WithNatural):
            return comp_lib.WithNatural(fallback)
        return fallback
    return comp


@dataclass(frozen=True)
class LeafPlan:
    """Everything static about one parameter leaf."""
    meta: Any                       # ParamMeta
    shape: tuple[int, ...]          # full leaf shape (no worker dim)
    stack_shape: tuple[int, ...]    # leading stack dims
    slice_shape: tuple[int, ...]    # per-layer operand the LMO/compressor sees
    n_stack: int                    # prod(stack_shape)
    w2s: Any                        # resolved worker->server compressor
    s2w: Any                        # resolved server->worker compressor


class LayerPlan:
    """Per-(shapes, metas) plan shared by every optimizer phase."""

    def __init__(self, paths: list[tuple], leaves: list[LeafPlan]):
        self.paths = paths
        self.leaves = leaves
        self._ns_buckets: dict = {}       # mesh key -> buckets
        self._stage_plans: dict = {}
        self._wire_layouts: dict = {}     # (dtype, direction) -> WireLayout
        self._staged_layouts: dict = {}   # (dtype, stage ids, direction)

    @classmethod
    def build(cls, params: Any, metas: Any, w2s: str = "identity",
              s2w: str = "identity") -> "LayerPlan":
        """``params`` may hold tensors on any device, meta tensors
        included — only ``.shape`` is read. ``metas`` mirrors the params
        tree with ParamMeta leaves; incompressible leaves get identity
        compressors in both directions."""
        with span("plan/build"):
            paths = leaf_paths(params)
            plans = []
            for path in paths:
                p, m = tree_get(params, path), tree_get(metas, path)
                shape = tuple(p.shape)
                stack, sshape = shape[:m.stack_dims], shape[m.stack_dims:]
                plans.append(LeafPlan(
                    meta=m, shape=shape, stack_shape=stack,
                    slice_shape=sshape,
                    n_stack=int(math.prod(stack)) if stack else 1,
                    w2s=resolve_compressor(
                        w2s if m.compressible else "identity", sshape),
                    s2w=resolve_compressor(
                        s2w if m.compressible else "identity", sshape)))
            return cls(paths, plans)

    # ------------------------------------------------------------- tree ops
    def flatten(self, tree: Any) -> list:
        return [tree_get(tree, p) for p in self.paths]

    def unflatten(self, leaves: list) -> dict:
        return tree_unflatten(self.paths, leaves)

    # ------------------------------------------------------ wire accounting
    def w2s_bytes_per_worker(self, wire_dtype: torch.dtype) -> int:
        """Static bytes of one worker->server message (Table 2): the sum
        over leaves of stack count x per-slice payload bytes."""
        return sum(lp.n_stack * lp.w2s.payload_bytes(lp.slice_shape,
                                                     wire_dtype)
                   for lp in self.leaves)

    def s2w_bytes_per_round(self, wire_dtype: torch.dtype) -> int:
        """Static bytes of one server->worker model-update broadcast, in
        the same Table-2 convention: the server sends one message, the
        compressed S = C_P(X - W)."""
        return sum(lp.n_stack * lp.s2w.payload_bytes(lp.slice_shape,
                                                     wire_dtype)
                   for lp in self.leaves)

    def dense_bytes(self, wire_dtype: torch.dtype) -> int:
        """Uncompressed wire cost of the same message."""
        return dense_payload_bytes((lp.shape for lp in self.leaves),
                                   wire_dtype)

    # ------------------------------------------------------- NS bucketing
    def ns_buckets(self, mesh=None, fsdp: bool = False) -> tuple:
        """Shape buckets over the spectral leaves — the grouping behind
        the batched Newton-Schulz dispatch of the optimizer's phase 5.
        With ``mesh`` each bucket also carries its ``ns_bucket_pspec``.
        Built once per plan and (mesh shape, fsdp)."""
        key = _mesh_key(mesh, fsdp)
        if key not in self._ns_buckets:
            from repro_torch.dist.bucketing import build_buckets
            with span("plan/ns_buckets"):
                self._ns_buckets[key] = build_buckets(self, mesh=mesh,
                                                      fsdp=fsdp)
        return self._ns_buckets[key]

    # ------------------------------------------------------- wire staging
    def stage_plan(self, wire_stages="auto", ns_steps: int = 5, mesh=None,
                   fsdp: bool = False):
        """The staged-wire-pipeline partition of this plan's leaves
        (DESIGN.md §8): stage 0 carries the per-leaf-path (eager) leaves,
        then one stage per NS bucket descending by NS FLOPs, capped at
        ``wire_stages``. Built once per (mesh shape, fsdp, wire_stages,
        ns_steps)."""
        from repro_torch.dist.pipeline import build_stage_plan
        key = (_mesh_key(mesh, fsdp), wire_stages, ns_steps)
        if key not in self._stage_plans:
            with span("plan/stage_plan"):
                self._stage_plans[key] = build_stage_plan(
                    self, self.ns_buckets(mesh=mesh, fsdp=fsdp),
                    wire_stages=wire_stages, ns_steps=ns_steps)
        return self._stage_plans[key]

    def wire_layout(self, wire_dtype: torch.dtype, direction: str = "w2s"):
        """The static WireLayout (``repro_torch.wire``) of this plan's
        worker->server message (``"w2s"``) or of the server's model-update
        broadcast (``"s2w"``), memoised per (wire dtype, direction):
        ``total_nbytes`` is exactly what that direction's u8 collective
        moves per worker or per round, beside the analytic Table-2
        ``w2s_bytes_per_worker`` / ``s2w_bytes_per_round`` (which keep the
        paper's 4-byte-index convention)."""
        from repro_torch.wire.layout import build_layout
        key = (wire_dtype, direction)
        if key not in self._wire_layouts:
            with span("plan/wire_layout"):
                self._wire_layouts[key] = build_layout(self, wire_dtype,
                                                       direction=direction)
        return self._wire_layouts[key]

    def staged_wire_layout(self, wire_dtype: torch.dtype, stage_plan,
                           direction: str = "w2s"):
        """The ``StagedWireLayout`` cutting ``wire_layout(wire_dtype,
        direction)`` along ``stage_plan``, memoised per (wire dtype,
        partition, direction). Both directions cut the same partition, so
        each s2w broadcast pairs with one w2s gather per stage."""
        from repro_torch.wire.layout import build_staged_layout
        ids = tuple(s.leaf_ids for s in stage_plan.stages)
        key = (wire_dtype, ids, direction)
        if key not in self._staged_layouts:
            with span("plan/staged_wire_layout"):
                self._staged_layouts[key] = build_staged_layout(
                    self.wire_layout(wire_dtype, direction), ids)
        return self._staged_layouts[key]


def _mesh_key(mesh, fsdp) -> tuple | None:
    """A mesh's axis names and sizes (and ``fsdp``), or None."""
    if mesh is None:
        return None
    return (tuple(mesh.axis_names),
            tuple(mesh.shape[a] for a in mesh.axis_names), fsdp)


def dense_payload_bytes(shapes, wire_dtype: torch.dtype) -> int:
    """Wire bytes of an uncompressed message over the given leaf shapes."""
    itemsize = torch.empty((), dtype=wire_dtype).element_size()
    return sum(int(math.prod(s)) * itemsize for s in shapes)
