"""Static wire layout: a whole per-step message as ONE uint8 buffer
with a precomputed offset table (DESIGN.md §6, §8, §9).

Port of ``repro/wire/layout.py``. Built once per (LayerPlan, wire dtype,
direction): ``"w2s"`` lays out each worker's payloads under the leaves'
worker->server compressors (``lp.w2s``), ``"s2w"`` the server's EF21-P
model update under ``lp.s2w``, one message with lead dim 1. Each leaf's
payload structure comes from running its compressor's ``compress`` on a
``meta`` tensor (the counterpart of ``jax.eval_shape``), which allocates
nothing; the byte machinery is the same for both directions.

Buffer layout, per message:

    [ leaf 0: stack slice 0 | stack slice 1 | ... ][ leaf 1: ... ] ...

Each slice region is that compressor's payload leaves, in
``jax.tree.flatten`` order, each encoded by its codec (``codecs.py``).
``pack`` takes per-leaf payloads with ``[lead, *stack]`` leading dims
(``lead`` = n_workers for w2s, 1 for s2w) and gives a ``[lead,
total_nbytes]`` buffer: every codec runs once per leaf over all ``lead *
n_stack`` slices as rows. ``unpack`` is the bit-exact inverse, so the
EF21 and EF21-P sender/receiver invariant survives the wire. ``StagedWireLayout`` cuts the same bytes into K contiguous
stage sub-buffers along the staged pipeline's leaf partition.

Both work in place: ``pack`` allocates the buffer once and each codec
writes its column of each leaf's region, ``[lead, n_stack, nbytes]``
(``WireSpec.region``, a view), so every byte is written once;
``unpack`` hands the codecs the same views, and gets views of the buffer
back wherever a leaf's bytes can be read where they lie.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from .codecs import flatten_payload, leaf_codecs, unflatten_payload


def _payload_struct(comp: Any, slice_shape: tuple[int, ...],
                    in_dtype: torch.dtype) -> Any:
    """The payload of one slice, on the ``meta`` device."""
    x = torch.zeros(slice_shape, dtype=in_dtype, device="meta")
    state = comp.init(None, slice_shape, in_dtype, device="meta")
    payload, _ = comp.compress(state, x, slice_shape)
    return payload


@dataclass(frozen=True)
class WireSpec:
    """Everything static about one parameter leaf's wire region."""
    offset: int                     # byte offset of the leaf region
    slice_nbytes: int               # packed bytes of ONE stack slice
    stack_shape: tuple[int, ...]
    n_stack: int
    codec_id: str                   # human-readable codec summary
    names: tuple                    # payload leaf names, flatten order
    codecs: tuple                   # per payload leaf, flatten order
    splits: tuple[int, ...]         # byte offsets of payload leaves

    @property
    def region_nbytes(self) -> int:
        return self.n_stack * self.slice_nbytes

    def region(self, buf: torch.Tensor) -> torch.Tensor:
        """This leaf's region of a ``[lead, nbytes]`` wire buffer, as the
        view ``[lead, n_stack, slice_nbytes]``."""
        return buf[:, self.offset:self.offset + self.region_nbytes] \
            .unflatten(1, (self.n_stack, self.slice_nbytes))

    def pack_rows(self, payload: Any, out: torch.Tensor) -> torch.Tensor:
        """Payload with leaves ``[*lead, *leaf_shape]`` -> its bytes,
        written into uint8 ``out`` ``[*lead, slice_nbytes]``."""
        _, leaves = flatten_payload(payload)
        for c, o, x in zip(self.codecs, self.splits, leaves, strict=True):
            c.pack(x, out=out[..., o:o + c.nbytes])
        return out

    def unpack_rows(self, buf: torch.Tensor) -> Any:
        """Inverse of ``pack_rows``: leaves ``[*lead, *leaf_shape]``."""
        return unflatten_payload(self.names, [
            c.unpack(buf[..., o:o + c.nbytes])
            for c, o in zip(self.codecs, self.splits)])


@dataclass(frozen=True)
class WireLayout:
    """Offset table + pack/unpack for the full per-step message."""
    specs: tuple[WireSpec, ...]     # aligned with LayerPlan.leaves
    total_nbytes: int               # exact bytes of one message
    direction: str = "w2s"          # "w2s" or "s2w": whose compressors

    def pack(self, flat_payloads: list) -> torch.Tensor:
        """Per-leaf payloads (leaves ``[lead, *stack, ...]``) -> ``[lead,
        total_nbytes]`` uint8 buffer."""
        first = flatten_payload(flat_payloads[0])[1][0]
        lead = first.shape[0]
        buf = torch.empty((lead, self.total_nbytes), dtype=torch.uint8,
                          device=first.device)
        for spec, payload in zip(self.specs, flat_payloads, strict=True):
            names, leaves = flatten_payload(payload)
            rows = [x.reshape((lead, spec.n_stack) + c.shape)
                    for x, c in zip(leaves, spec.codecs)]
            spec.pack_rows(unflatten_payload(names, rows), spec.region(buf))
        return buf

    def unpack(self, buf: torch.Tensor) -> list:
        """Bit-exact inverse of ``pack`` (same per-leaf convention)."""
        lead = buf.shape[0]
        out = []
        for spec in self.specs:
            names, leaves = flatten_payload(
                spec.unpack_rows(spec.region(buf)))
            out.append(unflatten_payload(names, [
                x.view((lead,) + spec.stack_shape + c.shape)
                for x, c in zip(leaves, spec.codecs)]))
        return out

    def describe(self) -> list[dict]:
        """Static offset table (one row per leaf) for reports/tests."""
        return [{"offset": s.offset, "slice_nbytes": s.slice_nbytes,
                 "n_stack": s.n_stack, "codec": s.codec_id}
                for s in self.specs]


@dataclass(frozen=True)
class StagedWireLayout:
    """K contiguous stage sub-buffers repartitioning one ``WireLayout``
    along the staged wire pipeline (DESIGN.md §8).

    Each stage is a ``WireLayout`` over a subset of the plan's leaves,
    offsets rebased to be contiguous within the stage: every leaf keeps
    its byte layout, only its home buffer changes, and the stage byte
    counts sum to ``base.total_nbytes``."""
    base: WireLayout
    stage_leaf_ids: tuple[tuple[int, ...], ...]  # per stage, plan-leaf ids
    stages: tuple[WireLayout, ...]

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def total_nbytes(self) -> int:
        return self.base.total_nbytes

    def stage_nbytes(self, k: int) -> int:
        return self.stages[k].total_nbytes

    def pack_stage(self, k: int, flat_payloads: list) -> torch.Tensor:
        """Stage ``k``'s leaves of the FULL plan-flat payload list ->
        that stage's ``[lead, stage_nbytes(k)]`` sub-buffer."""
        return self.stages[k].pack(
            [flat_payloads[i] for i in self.stage_leaf_ids[k]])

    def unpack_stage(self, k: int, buf: torch.Tensor) -> list:
        """Bit-exact inverse of ``pack_stage``: payloads aligned with
        ``stage_leaf_ids[k]``."""
        return self.stages[k].unpack(buf)


def build_staged_layout(layout: WireLayout,
                        stage_leaf_ids) -> StagedWireLayout:
    """Repartition ``layout`` into per-stage sub-layouts; the stage leaf
    id lists must partition ``range(len(layout.specs))``."""
    stage_leaf_ids = tuple(tuple(ids) for ids in stage_leaf_ids)
    flat = [i for ids in stage_leaf_ids for i in ids]
    if sorted(flat) != list(range(len(layout.specs))):
        raise ValueError(
            f"stage leaf ids {stage_leaf_ids} do not partition the "
            f"{len(layout.specs)} layout leaves")
    stages = []
    for ids in stage_leaf_ids:
        specs, offset = [], 0
        for i in ids:
            spec = dataclasses.replace(layout.specs[i], offset=offset)
            offset += spec.region_nbytes
            specs.append(spec)
        stages.append(WireLayout(specs=tuple(specs), total_nbytes=offset,
                                 direction=layout.direction))
    assert sum(s.total_nbytes for s in stages) == layout.total_nbytes
    return StagedWireLayout(base=layout, stage_leaf_ids=stage_leaf_ids,
                            stages=tuple(stages))


def build_layout(plan: Any, wire_dtype: torch.dtype,
                 direction: str = "w2s") -> WireLayout:
    """The WireLayout of a LayerPlan's worker->server message
    (``direction="w2s"``, each leaf's ``lp.w2s``) or server->worker model
    update (``"s2w"``, ``lp.s2w``)."""
    if direction not in ("w2s", "s2w"):
        raise ValueError(f"direction must be 'w2s' or 's2w', got "
                         f"{direction!r}")
    specs = []
    offset = 0
    for lp in plan.leaves:
        comp = getattr(lp, direction)
        in_dtype = (torch.float32 if getattr(comp, "lossless_wire", False)
                    else wire_dtype)
        struct = _payload_struct(comp, lp.slice_shape, in_dtype)
        codecs, names = leaf_codecs(comp, lp.slice_shape, struct)
        splits, pos = [], 0
        for c in codecs:
            splits.append(pos)
            pos += c.nbytes
        cid = comp.name + "[" + "+".join(c.cid for c in codecs) + "]"
        specs.append(WireSpec(
            offset=offset, slice_nbytes=pos, stack_shape=lp.stack_shape,
            n_stack=lp.n_stack, codec_id=cid, names=names, codecs=codecs,
            splits=tuple(splits)))
        offset += specs[-1].region_nbytes
    return WireLayout(specs=tuple(specs), total_nbytes=offset,
                      direction=direction)
