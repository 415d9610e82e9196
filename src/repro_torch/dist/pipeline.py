"""Stage assignment for the staged wire pipeline (DESIGN.md §8).

Port of ``repro/dist/pipeline.py:41-115``. The plan's leaves are cut
into K *wire stages* aligned with the Newton-Schulz buckets that consume
them:

  * stage 0 is the **eager** chunk: every leaf the per-leaf phase-5 path
    handles (non-spectral leaves, spectral leaves without a 2-D slice);
  * every NS bucket gets a stage, ordered **descending by NS FLOPs**, so
    the biggest batched chains run first while later stages' gathers
    are still in flight (the optimizer issues all K gathers up front);
  * ``wire_stages=N`` caps the count by merging the smallest-FLOP
    buckets into the last stage (1 collapses to the monolithic path;
    ``"auto"`` keeps one stage per bucket).

A stage is a pure repartition of the wire buffer
(``wire.layout.StagedWireLayout``), so the staged step is bit-equal to
the monolithic one. The server->worker issue order
(``s2w_issue_order``) comes with the EF21-P leg (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

from dataclasses import dataclass


def bucket_ns_flops(bucket, ns_steps: int = 5) -> float:
    """Static FLOP estimate of one bucket's batched Newton-Schulz chain:
    per slice and iteration, the gram (2·m²·n), the poly's A² (2·m³) and
    the update (2·m²·n). Only orders stages."""
    m, n = bucket.shape
    return float(ns_steps) * bucket.batch * (4.0 * m * m * n + 2.0 * m ** 3)


@dataclass(frozen=True)
class WireStage:
    """One stage: which plan leaves ride its sub-buffer and which NS
    buckets its unpack feeds."""
    leaf_ids: tuple[int, ...]      # plan-leaf ids
    bucket_ids: tuple[int, ...]    # indices into plan.ns_buckets()
    ns_flops: float                # static NS FLOPs this stage runs


@dataclass(frozen=True)
class StagePlan:
    """Leaf -> stage partition of a LayerPlan (``LayerPlan.stage_plan``)."""
    stages: tuple[WireStage, ...]
    eager_leaf_ids: tuple[int, ...]   # stage-0 per-leaf-path leaves

    @property
    def n_stages(self) -> int:
        return len(self.stages)


def build_stage_plan(plan, buckets, wire_stages="auto",
                     ns_steps: int = 5) -> StagePlan:
    """Partition ``plan``'s leaves into wire stages along ``buckets``
    (``plan.ns_buckets()``). Deterministic: bucket stages descend by
    ``bucket_ns_flops`` (ties on bucket index); every leaf lands in
    exactly one stage."""
    if wire_stages != "auto":
        wire_stages = int(wire_stages)
        if wire_stages < 1:
            raise ValueError(f"wire_stages must be >= 1, got {wire_stages}")
    bucketed = {i for b in buckets for i in b.leaf_ids}
    eager = tuple(i for i in range(len(plan.leaves)) if i not in bucketed)
    order = sorted(range(len(buckets)),
                   key=lambda bi: (-bucket_ns_flops(buckets[bi], ns_steps),
                                   bi))
    stages: list[WireStage] = []
    if eager:
        stages.append(WireStage(leaf_ids=eager, bucket_ids=(), ns_flops=0.0))
    for bi in order:
        b = buckets[bi]
        stages.append(WireStage(leaf_ids=tuple(sorted(b.leaf_ids)),
                                bucket_ids=(bi,),
                                ns_flops=bucket_ns_flops(b, ns_steps)))
    if wire_stages != "auto" and len(stages) > wire_stages:
        # merge the smallest-FLOP tail; the eager stage stays stage 0
        head, tail = stages[:wire_stages - 1], stages[wire_stages - 1:]
        merged = WireStage(
            leaf_ids=tuple(sorted(i for s in tail for i in s.leaf_ids)),
            bucket_ids=tuple(bi for s in tail for bi in s.bucket_ids),
            ns_flops=sum(s.ns_flops for s in tail))
        stages = head + [merged]
    return StagePlan(stages=tuple(stages), eager_leaf_ids=eager)
