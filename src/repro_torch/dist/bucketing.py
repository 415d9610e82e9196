"""Shape-bucketed Newton-Schulz dispatch (DESIGN.md §7).

Port of ``repro/dist/bucketing.py``. The spectral leaves of a
``LayerPlan`` are grouped by canonical slice shape ``(m, n)`` with m <= n,
so phase 5 runs one batched NS chain per distinct shape:

  * a ``[768, 3072]`` up-projection and a ``[3072, 768]`` down-projection
    share a bucket; a per-leaf transpose flag records the swap;
  * stacked leaves (``stack_dims > 0``) fold their stack dims into the
    batch dim with one reshape;
  * the per-slice LMO radius scales ride along as a ``[batch]`` vector;
  * built against a mesh (``dist.sharding.MeshShape``), each bucket
    carries the ``ns_bucket_pspec`` of its ``[B, m, n]`` stack, and a
    shape is sub-split by the canonical orientation of its members'
    ``model`` axis where the mesh has one. Over a group's ``{"data": P}``
    the membership, order and stages stay the mesh-less ones; the spec
    says which ranks split a bucket's slices (``kernels.ops``).

``stack``/``unstack`` are exact inverses (transpose + reshape only).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.dist.sharding import ns_bucket_pspec, param_pspec


@dataclass(frozen=True)
class NSBucket:
    """Static description of one shape bucket of spectral leaves."""
    shape: tuple[int, int]             # canonical slice shape, m <= n
    leaf_ids: tuple[int, ...]          # indices into plan.leaves
    leaf_shapes: tuple[tuple[int, ...], ...]  # full leaf shapes (with stack)
    transposes: tuple[bool, ...]       # per leaf: slice stored as [n, m]
    counts: tuple[int, ...]            # per leaf: n_stack slices contributed
    radius_scales: tuple[float, ...]   # per slice, len == batch
    pspec: Any = None                  # spec of the [B, m, n] stack
                                       # (ns_bucket_pspec; None off-mesh)

    @property
    def batch(self) -> int:
        return sum(self.counts)

    def stack(self, leaves: list[torch.Tensor],
              dtype: torch.dtype | None = None) -> torch.Tensor:
        """Fold per-leaf tensors ``[*stack, s0, s1]`` into one canonical
        ``[batch, m, n]`` stack in ``leaf_ids`` order."""
        if dtype is None and len({x.dtype for x in leaves}) > 1:
            offenders = ", ".join(
                f"leaf {lid}[{sh}]: {x.dtype}" for lid, sh, x in
                zip(self.leaf_ids, self.leaf_shapes, leaves))
            raise TypeError(
                f"NSBucket.stack: mixed leaf dtypes in bucket "
                f"{self.shape} ({offenders}) — pass dtype= to unify")
        parts = []
        for x, tr in zip(leaves, self.transposes, strict=True):
            x = x.reshape((-1,) + tuple(x.shape[x.ndim - 2:]))
            if tr:
                x = x.transpose(-1, -2)
            parts.append(x if dtype is None else x.to(dtype))
        return torch.cat(parts, 0).contiguous()

    def unstack(self, batch: torch.Tensor) -> list[torch.Tensor]:
        """Exact inverse of ``stack`` (up to dtype, which the caller
        restores)."""
        out, off = [], 0
        for full_shape, tr, cnt in zip(self.leaf_shapes, self.transposes,
                                       self.counts):
            piece = batch[off:off + cnt]
            off += cnt
            if tr:
                piece = piece.transpose(-1, -2)
            out.append(piece.reshape(full_shape))
        return out

    def radius_vector(self, t, device: torch.device) -> torch.Tensor:
        """Per-slice trust-region radii ``t * scale_i`` as a [batch] f32
        vector."""
        scales = torch.tensor(self.radius_scales, dtype=torch.float32,
                              device=device)
        return torch.as_tensor(t, dtype=torch.float32, device=device) * scales


def build_buckets(plan, mesh=None, fsdp: bool = False
                  ) -> tuple[NSBucket, ...]:
    """Group the spectral 2-D leaves of a LayerPlan by canonical slice
    shape. Deterministic: buckets sorted by shape (then by the canonical
    position of ``model``), leaves in plan order within a bucket.
    Non-spectral leaves are left to the per-leaf path.

    With ``mesh`` (only ``shape`` and ``axis_names`` are read) each
    bucket carries its ``ns_bucket_pspec``, from its members'
    ``param_pspec`` in canonical orientation; where the mesh has a
    ``model`` axis a shape's members split by where they carry it, and
    members without it fold into the one orientation of their shape
    unless they carry ``model`` on a stack dim (expert parallel)."""
    model_n = mesh.shape.get("model", 1) if mesh is not None else 1
    groups: dict[tuple, list] = {}
    for i, lp in enumerate(plan.leaves):
        if lp.meta.lmo != "spectral" or len(lp.slice_shape) != 2:
            continue
        s0, s1 = lp.slice_shape
        tr = s0 > s1
        shape = (s1, s0) if tr else (s0, s1)
        spec = mpos = None
        smodel = False
        if mesh is not None and model_n > 1:
            full = param_pspec(lp.meta, lp.shape, mesh, fsdp=fsdp)
            row, col = full[-2], full[-1]
            if tr:
                row, col = col, row
            spec = (row, col)
            mpos = 0 if row == "model" else (1 if col == "model" else None)
            smodel = "model" in full[:-2]
        groups.setdefault((shape, mpos), []).append((i, lp, tr, spec, smodel))
    if model_n > 1:
        for shape in {s for s, _ in groups}:
            tp = [p for s, p in groups if s == shape and p is not None]
            none_members = groups.get((shape, None))
            if none_members and len(tp) == 1 \
                    and not any(sm for *_, sm in none_members):
                groups[(shape, tp[0])] = sorted(
                    groups[(shape, tp[0])] + groups.pop((shape, None)),
                    key=lambda e: e[0])
    buckets = []
    for key in sorted(groups, key=lambda k: (k[0], -1 if k[1] is None
                                             else k[1])):
        shape, _ = key
        members = groups[key]
        scales = []
        for _, lp, *_ in members:
            scales.extend([float(lp.meta.radius_scale)] * lp.n_stack)
        pspec = None
        if mesh is not None:
            pspec = ns_bucket_pspec(
                sum(lp.n_stack for _, lp, *_ in members), shape,
                [spec for *_, spec, _ in members if spec is not None],
                mesh, stack_model=any(sm for *_, sm in members))
            if all(a is None for a in pspec):
                pspec = None
        buckets.append(NSBucket(
            shape=shape,
            leaf_ids=tuple(i for i, *_ in members),
            leaf_shapes=tuple(lp.shape for _, lp, *_ in members),
            transposes=tuple(tr for _, _, tr, *_ in members),
            counts=tuple(lp.n_stack for _, lp, *_ in members),
            radius_scales=tuple(scales),
            pspec=pspec))
    return tuple(buckets)
