"""EF21-Muon — the paper's contribution (Algorithms 1-3) in PyTorch.

Port of ``repro/core/muon.py``: the bidirectional step of
``muon.py:413-950``, phases 1-5, with elastic participation, faults,
metrics and the desynchronized-worker rejoin (``resync``), on one
process or as one rank of a group that spreads the workers (``workers``,
``dist/sharding.py``).

    opt   = EF21Muon(cfg)
    state = opt.init(generator, params, metas)
    step  = opt.make_step(metas, reshard_payloads=None,
                          reshard_updates=None, faults=None,
                          donate=False, workers=None,
                          gather_scalars=None)
    state, aux = step(state, grad_and_loss, batch, t)

``grad_and_loss(params, batch_slice) -> (loss, grads)`` and every batch
entry has a leading worker dimension of size ``len(workers)``: the
workers this process owns (``workers``, a range of global worker ids;
all ``cfg.n_workers`` by default); each worker gets its own autograd
pass. The worker dimension leads every per-worker state tensor, as in
the reference state, and holds the same workers. Every mask
(participation, reception, drops, the guard's) is global and computed
alike on every rank; each rank indexes it by global worker id where it
touches its own workers' state. The payload hook gathers the workers'
messages into ``[n_workers, ...]``, so the fold and the LMO see every
worker on every rank; ``gather_scalars`` gathers the per-worker scalars
(the losses and per-worker metrics, ``[len(workers), m]`` f32) once a
step, so ``aux`` is the one-process step's, bit for bit.

Phase 1 is EF21-P (``cfg.s2w``): the server sends S = C_P(X - W) and
both ends advance the workers' model estimate W by it; the workers
differentiate at W (phase 2). With ``s2w="identity"`` W is X itself and
the state keeps no W. The two hooks are the trainer's collectives:
``reshard_payloads`` the worker->server all-gather, ``reshard_updates``
the server->worker broadcast (it defaults to ``reshard_payloads``, as in
the reference). With a hook and ``cfg.wire_pack`` (``wire_pack_s2w``
for phase 1) each direction packs its messages into the uint8 wire
(``repro_torch.wire``), hands each buffer to its hook and unpacks what
comes back: staged (one buffer per wire stage, all issued before the
first is consumed, DESIGN.md §8, §9) or monolithic (one buffer,
``wire_stages=1``). The packed s2w sender compresses only
(``ef_compress``) and, like every worker, advances W from the wire bytes
(``apply_payload``). Pack -> unpack is bit-exact, so every arm is
bit-equal to the hook-less step, which packs nothing (as ``muon.py:404``).
Compressors that keep state (RankK's warm-started sketches) carry one
state per message: ``cw_state`` per worker and stack slice, ``cs_state``
per stack slice; phases 1 and 3 hand each leaf its state and keep the
new one.

Elastic participation (§11): with ``cfg.participation`` other than
"full", the non-finite guard or a fault plan, the server folds only the
step's participants (the scheduled mask, ANDed with the faults' drops
and, after unpack, with each worker's payload finiteness), normalised by
their dynamic count, and the absent workers' G_j, M_j and compressor
states stay as they were, bit for bit; with no participant X and
g_server stay too. Every decision on the device is a ``torch.where``:
the host branches only on its own step number.

Resync (§13, ``cfg.resync = R``): each worker keeps its own model
estimate W_j (``w_w``, worker-lead) and differentiates at it; the state
adds a version vector and a ring of the last R s2w rounds' packed bytes
(``dist/resync.py``). A worker that missed rounds (the reception mask:
schedule AND drops) replays them from the ring on its return, each slot
decompressed once and added with ``apply_payload``'s arithmetic, so its
W_j has the server's W's bits; past R rounds it takes a copy of W. The
ring's row is the broadcast's stage buffers in stage order (staged), the
one buffer (monolithic) or the monolithic layout's pack of the message
(unpacked): its bytes depend on the arm, the W they decode to does not.

Server placement over a group (``server``, a
``dist.sharding.ServerPlacement``): each NS bucket the group's P ranks
divide (``ns_bucket_pspec``) runs on each rank for its P-th of the
slices only, and the updated x rows, in x's dtype, are all-gathered or,
where zero-1 cuts a member's stack, sent to the ranks that hold them.
With the placement's chunks (zero-1 or FSDP) ``x``, ``g_server`` and
``w`` hold the rank's chunk of each leaf between steps; the step gathers
a leaf whole, one leaf or one bucket at a time, where it needs it (the
s2w compress, W for the gradients, the resync's full copy, the LMO) and
folds, advances W and freezes chunk by chunk (elementwise, so the same
bits). Every gather is the placement's, checked by size.

Model cuts over a mesh (``cuts``, a ``dist.sharding.ModelCuts`` of the
trainer's ``RankMesh``): ``x``, ``g_server``, ``w`` and the inner dims
of the worker-lead leaves hold the rank's chunks of each leaf cut on
``model``. The compressors see each leaf whole: each EF21 round
gathers its difference (``M_j - G_j``, ``X - W``, cast to the wire
dtype) over the model subgroup, so every rank of a data row sends the
same payload, and keeps its chunk of every decoded delta (the add is
elementwise: the chunk gets the whole add's bits). The fold runs on the
chunks; the LMO of a cut leaf gathers its gradient whole (the sign LMO
runs on the chunk); a bucket whose columns are cut runs the NS chain on
the rank's columns (``kernels.ops.newton_schulz_cols``), any other
gathers its members whole, and each splits its slices over the axes its
``ns_bucket_pspec`` puts the batch dim on (any axis of the mesh or a
composition, ``("pod", "data")`` pod-major) and gathers the direction's
rows back. With ``worker_data`` (FSDP on a pod mesh) the worker-lead
leaves' inner dims are also cut over ``data``: the difference a worker
compresses is gathered whole over ``data``, then over ``model``. The
metrics read the same values as one process's: a cut leaf's per-worker
squares summed over the subgroups that hold it before the root (one
stacked sum a subgroup), a column-cut bucket's residual grams summed
over ``model``; they add collectives, never a change to the state.

``donate=True`` lets the step write W, M_j, G_j, g_server and X into the
input state's tensors (the caller must not use that state again), the
same arithmetic in the same order, so the same bits; an elastic step
updates only W in place, since its commit needs the old values (so
resync's W_j and ring too go in place only in a step that is not
elastic). Without it the step leaves its input state untouched.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.dist.layerwise import (LayerPlan, leaf_paths, per_slice,
                                       tree_leaves)
from repro_torch.dist.participation import (mask_bcast, mask_to_device,
                                            payload_finite_mask,
                                            reception_mask, validate_spec)
from repro_torch.dist.pipeline import s2w_issue_order
from repro_torch.dist.resync import (init_resync_state, replay_masks,
                                     resolve_ring_depth, ring_push)
from repro_torch.dist.sharding import mesh_for
from repro_torch.kernels.natural_pack import fold_f32
from repro_torch.kernels.ops import (newton_schulz_cols, newton_schulz_rows,
                                     split_rows)
from repro_torch.obs.metrics import (MetricSet, leaf_names,
                                     orth_residual_slices,
                                     rel_error_of_norms)
from repro_torch.obs.trace import (PHASE_SPANS, RESYNC_SPAN, phase_span,
                                   wire_stage_span)
from repro_torch.wire.codecs import flatten_payload, unflatten_payload

from .error_feedback import (add_delta, apply_payload, cast, ef_compress,
                             ef_compress_step)
from .lmo import lmo_direction, lmo_direction_batched


@dataclass(frozen=True)
class ParamMeta:
    """Per-leaf optimizer metadata (the 'layer' of the layer-wise method)."""
    lmo: str = "spectral"          # norm kind for the LMO step
    radius_scale: float = 1.0      # per-layer radius multiplier t_i = scale * t
    stack_dims: int = 0            # leading dims that stack independent layers
    compressible: bool = True      # False => identity w2s compressor


@dataclass(frozen=True)
class EF21MuonConfig:
    n_workers: int = 1
    beta: float = 0.1              # gradient weight: M = (1-beta) M + beta g
    w2s: str = "identity"          # worker->server compressor (C_D)
    s2w: str = "identity"          # server->worker compressor (C_P)
    ns_steps: int = 5
    wire_dtype: torch.dtype = torch.bfloat16
    state_dtype: torch.dtype = torch.float32
    wire_pack: bool = True         # fuse payloads into one uint8 wire buffer
                                   # (only where there is a hook)
    ns_bucketing: bool = True      # batch spectral LMOs by shape bucket (§7)
    wire_stages: Any = "auto"      # staged wire pipeline (§8): "auto" = one
                                   # stage per NS bucket + the eager chunk;
                                   # 1 = the monolithic single-gather path
                                   # (bit-identical A/B arm); N caps stages
    wire_pack_s2w: Any = "auto"    # pack the EF21-P model update through
                                   # the s2w wire (§9): "auto" follows
                                   # wire_pack; False keeps the unpacked
                                   # phase 1 (the bit-equal A/B arm)
    metrics: bool = False          # collect the MetricSet (§10) into
                                   # aux["metrics"]: pure reads, the
                                   # update's bits unchanged
    trace_spans: bool = False      # record_function (and NVTX on a card)
                                   # around the five phases and every
                                   # wire stage (§10); off = no span code
    participation: Any = "full"    # elastic participation (§11): "full",
                                   # "bernoulli(p)", "round_robin(k)" or a
                                   # dist.participation.Explicit table;
                                   # "full" takes the pre-§11 code path
    participation_seed: int = 0    # seeds bernoulli schedules
    nonfinite_guard: bool = False  # demote a worker whose payload carries
                                   # NaN/Inf for the step (§11); forced on
                                   # by a fault plan
    resync: Any = None             # desynchronized-worker rejoin (§13):
                                   # None/0 off (the step without it); an
                                   # int R >= 1 keeps per-worker W_j, a
                                   # version vector and a ring of the
                                   # last R packed s2w rounds: a worker
                                   # absent <= R rounds replays them, a
                                   # longer absence copies W. Needs a
                                   # compressing s2w leg


_RESYNC_NEEDS_S2W = ("resync requires a compressing s2w leg (s2w != "
                     "'identity'): rejoin replays the server->worker "
                     "broadcast stream")


@dataclass(frozen=True)
class WireBudget:
    """The static per-step collective budget of the two wire legs:
    exactly ``len(w2s_sizes)`` worker->server u8 all-gathers, each moving
    its listed bytes per worker, and ``len(s2w_sizes)`` server->worker u8
    broadcasts of the listed bytes, in stage order (one entry per stage
    sub-buffer; monolithic => one entry; an unpacked direction => none).
    The broadcasts are issued in ``s2w_issue_order``."""
    pack_w2s: bool
    pack_s2w: bool
    n_stages: int                  # effective pipeline stages (1 = mono)
    w2s_sizes: tuple[int, ...]     # expected u8 bytes per worker, per gather
    s2w_sizes: tuple[int, ...]
    n_workers: int = 1

    @property
    def w2s_nbytes(self) -> int:
        return sum(self.w2s_sizes)

    @property
    def s2w_nbytes(self) -> int:
        return sum(self.s2w_sizes)

    @property
    def two_way_nbytes(self) -> int:
        return self.w2s_nbytes + self.s2w_nbytes


def resolve_pack_s2w(cfg: EF21MuonConfig, distributed: bool) -> bool:
    """The resolved s2w pack switch (§9): a compressing C_P and a hook,
    then ``wire_pack_s2w``, whose "auto" follows ``wire_pack``. Shared
    by ``make_step`` and ``wire_budget``."""
    return (cfg.s2w != "identity" and distributed
            and (cfg.wire_pack if cfg.wire_pack_s2w == "auto"
                 else bool(cfg.wire_pack_s2w)))


def resolve_stage_plan(cfg: EF21MuonConfig, plan: LayerPlan,
                       any_pack: bool = True, mesh=None, fsdp: bool = False):
    """The resolved stage partition (§8), or None when the pipeline
    collapses to the monolithic single-gather path: staging needs a
    packed direction, NS bucketing, ``wire_stages != 1`` and more than
    one effective stage."""
    if not (any_pack and cfg.ns_bucketing and cfg.wire_stages != 1):
        return None
    sp = plan.stage_plan(wire_stages=cfg.wire_stages, ns_steps=cfg.ns_steps,
                         mesh=mesh, fsdp=fsdp)
    return sp if sp.n_stages > 1 else None


def _lead(payload: Any, lead: int | None) -> Any:
    """A payload with a lead dim of 1 put in front of each tensor
    (``lead=1``: the server's one message) or taken off (``lead=0``)."""
    names, leaves = flatten_payload(payload)
    return unflatten_payload(names, [a[None] if lead else a[0]
                                     for a in leaves])


def _unpack_row(plan: LayerPlan, cfg: EF21MuonConfig, splan,
                row: torch.Tensor) -> list:
    """The per-leaf payloads (lead 1, views of ``row`` where their bytes
    can be read in place) of one replay-ring row: the staged s2w
    layout's stage sub-buffers one after another (``splan``), or the
    monolithic layout's buffer."""
    if splan is None:
        return plan.wire_layout(cfg.wire_dtype, "s2w").unpack(row[None])
    sw = plan.staged_wire_layout(cfg.wire_dtype, splan, "s2w")
    pls: list = [None] * len(plan.leaves)
    pos = 0
    for k in range(sw.n_stages):
        n = sw.stage_nbytes(k)
        for i, pl in zip(sw.stage_leaf_ids[k],
                         sw.unpack_stage(k, row[pos:pos + n][None])):
            pls[i] = pl
        pos += n
    return pls


class EF21Muon:
    def __init__(self, cfg: EF21MuonConfig):
        self.cfg = cfg
        self._plans: OrderedDict = OrderedDict()

    # ------------------------------------------------------------------ plan
    def plan(self, params: Any, metas: Any) -> LayerPlan:
        """The LayerPlan for these (shapes, dtypes, metas, compressors),
        cached LRU (8 entries, oldest dropped first)."""
        leaves = tree_leaves(params)
        key = (tuple(leaf_paths(params)),
               tuple(tuple(p.shape) for p in leaves),
               tuple(str(p.dtype) for p in leaves), tuple(tree_leaves(metas)),
               self.cfg.w2s, self.cfg.s2w)
        if key in self._plans:
            self._plans.move_to_end(key)
        else:
            if len(self._plans) >= 8:
                self._plans.popitem(last=False)
            self._plans[key] = LayerPlan.build(params, metas, w2s=self.cfg.w2s,
                                               s2w=self.cfg.s2w)
        return self._plans[key]

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator | None, params: Any,
             metas: Any, shapes: Any = None,
             workers: range | None = None) -> dict:
        """Optimizer state on the params' device. ``generator`` (a CPU
        ``torch.Generator``) draws the compressor states: RankK's
        sketches ``q``, ``[n_workers, *stack, n, r]`` per leaf in
        ``cw_state``, all of ``cw_state`` first, in leaf order (Identity,
        TopK and Natural keep none, and take None). A compressing s2w
        leg adds the workers' model estimate ``w`` (the params in
        ``state_dtype``) and the server's compressor states ``cs_state``,
        ``[*stack, n, r]`` per leaf. Resync adds each worker's estimate
        ``w_w`` (``[n_workers, ...]``, all equal to ``w``) and ``resync``:
        the version vector ``vv`` and the ring, ``[R, s2w total
        bytes]``.

        Over a mesh's ``model`` axis ``params`` are a rank's chunks and
        ``shapes`` the whole params (meta tensors do), which the plan and
        the compressor states follow; ``workers`` (the rank's) keeps only
        their rows of the worker-lead leaves, each compressor state drawn
        for every worker first, so the state is the one-rank state's
        slice."""
        cfg = self.cfg
        sd = cfg.state_dtype
        ring_depth = resolve_ring_depth(cfg.resync)
        if ring_depth and cfg.s2w == "identity":
            raise ValueError(_RESYNC_NEEDS_S2W)
        plan = self.plan(params if shapes is None else shapes, metas)
        x_l = plan.flatten(params)
        rows = range(cfg.n_workers) if workers is None else workers
        per_worker = lambda p: torch.zeros((len(rows),) + tuple(p.shape),
                                           dtype=sd, device=p.device)

        def mine(cw: dict) -> dict:
            # the rows of ``workers`` of a compressor state's draws
            if len(rows) == cfg.n_workers:
                return cw
            return {k: v[rows.start:rows.stop].clone()
                    if isinstance(v, torch.Tensor) else v
                    for k, v in cw.items()}

        state = {
            "step": 0,
            "x": params,
            "g_server": plan.unflatten([torch.zeros(p.shape, dtype=sd,
                                                    device=p.device)
                                        for p in x_l]),
            "g_w": plan.unflatten([per_worker(p) for p in x_l]),
            "m_w": None if cfg.beta >= 1.0 else plan.unflatten(
                [per_worker(p) for p in x_l]),
            # one compressor state per message: [n_workers, *stack]
            "cw_state": [mine(lp.w2s.init(generator, lp.slice_shape,
                                          cfg.wire_dtype,
                                          (cfg.n_workers,) + lp.stack_shape,
                                          p.device))
                         for lp, p in zip(plan.leaves, x_l)],
        }
        if cfg.s2w != "identity":
            state["w"] = plan.unflatten([p.to(sd, copy=True) for p in x_l])
            # the server's one message per stack slice: [*stack]
            state["cs_state"] = [lp.s2w.init(generator, lp.slice_shape,
                                             cfg.wire_dtype, lp.stack_shape,
                                             p.device)
                                 for lp, p in zip(plan.leaves, x_l)]
        if ring_depth:
            # every worker starts current, bit-equal to the server's W
            state["w_w"] = plan.unflatten([
                p.to(sd)[None].repeat((len(rows),) + (1,) * p.ndim)
                for p in x_l])
            state["resync"] = init_resync_state(
                cfg.n_workers, ring_depth,
                plan.wire_layout(cfg.wire_dtype, "s2w").total_nbytes,
                x_l[0].device)
        return state

    # ------------------------------------------------------------ bookkeeping
    def wire_bytes_per_worker(self, params: Any, metas: Any) -> int:
        """Exact bytes of one worker's uint8 wire buffer — what the
        payload all-gather moves per worker."""
        return self.plan(params, metas).wire_layout(
            self.cfg.wire_dtype).total_nbytes

    def wire_budget(self, params: Any, metas: Any,
                    distributed: bool = True, mesh=None) -> WireBudget:
        """The :class:`WireBudget` of ``make_step``'s phases 1 and 4 on
        ``params``, through the same switches the step uses.
        ``distributed=False`` is the hook-less step (nothing packed).
        ``mesh``: the step's mesh where it has a ``model`` axis (its NS
        buckets, and so its stages, split by the members' cuts)."""
        cfg = self.cfg
        plan = self.plan(params, metas)
        pack_w2s = bool(cfg.wire_pack and distributed)
        pack_s2w = resolve_pack_s2w(cfg, distributed)
        splan = resolve_stage_plan(cfg, plan, any_pack=pack_w2s or pack_s2w,
                                   mesh=mesh)

        def sizes(direction: str, packed: bool) -> tuple[int, ...]:
            if not packed:
                return ()
            if splan is not None:
                sw = plan.staged_wire_layout(cfg.wire_dtype, splan,
                                             direction)
                return tuple(sw.stage_nbytes(k) for k in range(sw.n_stages))
            return (plan.wire_layout(cfg.wire_dtype, direction).total_nbytes,)

        return WireBudget(pack_w2s, pack_s2w,
                          splan.n_stages if splan is not None else 1,
                          sizes("w2s", pack_w2s), sizes("s2w", pack_s2w),
                          n_workers=cfg.n_workers)

    # ------------------------------------------------------------------ step
    def make_step(self, metas: Any,
                  reshard_payloads: Callable | None = None,
                  reshard_updates: Callable | None = None,
                  faults=None, donate: bool = False,
                  workers: range | None = None,
                  gather_scalars: Callable | None = None,
                  server=None, fsdp: bool = False, cuts=None,
                  worker_data=None) -> Callable:
        """Returns ``step(state, grad_and_loss, batch, t) -> (state, aux)``;
        raises on what it does not run. ``reshard_payloads`` is the
        worker->server hook: it gets each ``[n_local, nbytes]`` uint8
        wire (sub-)buffer (or, with ``wire_pack=False``, the list of
        per-leaf payloads) and returns what every worker received.
        ``reshard_updates`` is the server->worker hook: it gets each
        ``[1, nbytes]`` uint8 s2w (sub-)buffer, the server's one message,
        and returns what every worker received, of the same shape; it
        defaults to ``reshard_payloads``, which suits only a hook that
        returns its input (a one-process test). A collective must come
        as ``reshard_updates``: an all-gather in its place would return
        ``[n_ranks, nbytes]`` and count the message as gathered bytes.
        None for both means single-process: nothing is packed.

        ``faults`` is a ``train.faults.FaultPlan`` (drops, poisoned
        gradient leaves, flipped wire bytes, injected inside the step);
        it forces the non-finite guard on. ``donate``: see the module
        docstring. ``workers`` and ``gather_scalars``: see the module
        docstring; a hook-less step owns every worker. ``server`` (a
        ``ServerPlacement`` over the group) and ``fsdp``: see the module
        docstring; ``server.params`` gives the leaves' whole shapes.
        ``cuts`` (a ``dist.sharding.ModelCuts``): the state's leaves are
        a rank's chunks over a mesh's ``model`` axis (see the module
        docstring); ``worker_data`` (a ``ServerPlacement`` over the data
        subgroup): the worker-lead leaves' inner dims are cut over
        ``data`` too (FSDP on a pod mesh)."""
        cfg = self.cfg
        validate_spec(cfg.participation, cfg.n_workers)
        workers = range(cfg.n_workers) if workers is None else workers
        if len(workers) < cfg.n_workers and reshard_payloads is None:
            raise ValueError("a step that owns some of the workers needs "
                             "the payload hook to gather the others'")
        lo = slice(workers.start, workers.stop)   # the global masks' rows
        # the masked fold and commit run only when something can mask:
        # "full" without the guard takes the pre-§11 path (bit-equal arm)
        guard = cfg.nonfinite_guard or faults is not None
        elastic = cfg.participation != "full" or guard
        inplace = donate and not elastic
        ring_depth = resolve_ring_depth(cfg.resync)
        if ring_depth and cfg.s2w == "identity":
            raise ValueError(_RESYNC_NEEDS_S2W)
        pack_wire = cfg.wire_pack and reshard_payloads is not None
        if reshard_updates is None:
            reshard_updates = reshard_payloads
        pack_s2w = resolve_pack_s2w(cfg, reshard_updates is not None)
        beta = cfg.beta
        group = None if server is None else server.group
        mesh = cuts.rm.mesh if cuts is not None else mesh_for(group)
        chunked = server is not None and server.sharded
        wdata = worker_data if worker_data is not None \
            and worker_data.sharded else None

        def whole(i: int, t: torch.Tensor) -> torch.Tensor:
            # leaf i of the server's state whole (a gather of its chunks)
            return server.whole(i, t) if chunked else t

        def local_data(i: int, t: torch.Tensor, lead: int = 0
                       ) -> torch.Tensor:
            # leaf i whole over ``data`` -> this rank's chunk of it
            return server.local(i, t, lead) if chunked else t

        def local(i: int, t: torch.Tensor, lead: int = 0) -> torch.Tensor:
            # leaf i whole (behind ``lead`` leading dims) -> this rank's
            # chunk: over a mesh its model cut, then any data cut
            if cuts is not None:
                t = cuts.cut(i, t, lead)
            return local_data(i, t, lead)

        def wpart(i: int, t: torch.Tensor, lead: int = 1) -> torch.Tensor:
            # leaf i's worker rows whole (behind ``lead`` dims) -> the
            # rank's chunk of a worker-lead leaf: its model cut, then any
            # data cut
            if cuts is not None:
                t = cuts.cut(i, t, lead)
            return t if wdata is None else wdata.local(i, t, lead)

        def wdata_whole(i: int, t: torch.Tensor, tag: str,
                        lead: int = 1) -> torch.Tensor:
            # a worker-lead leaf's chunk gathered whole over ``data``
            if wdata is None or wdata.dims[i] is None:
                return t
            return cuts.rm.gather(t, wdata.dims[i] + lead, tag, "data")

        def cut_kw(i: int, lead: int = 0, shape: tuple = ()) -> dict:
            # an EF21 round on the rank's chunks of leaf i: the difference
            # gathered whole for the compressor (a worker's over ``data``
            # first where it is cut there), the delta cut back
            if cuts is None:
                return {}
            if lead:
                return {"whole": lambda d: cuts.whole(
                            i, wdata_whole(i, d, "compressor_in", lead),
                            "compressor_in", lead),
                        "part": lambda d: wpart(i, d, lead),
                        "shape": shape + cuts.shapes[i]}
            return {"whole": lambda d: cuts.whole(i, d, "compressor_in"),
                    "part": lambda d: cuts.cut(i, d),
                    "shape": shape + cuts.shapes[i]}

        def norm_sq(x: torch.Tensor, lead: int = 1) -> torch.Tensor:
            # the squared F-norm over everything after ``lead`` dims
            return torch.sum(torch.square(x.to(torch.float32)),
                             dim=tuple(range(lead, x.ndim)))

        def summed(ids: list[int], sqs: list, lead: int = 1) -> list:
            # each rank's squares ``sqs[k]`` of its chunk of leaf ids[k]
            # summed over the subgroups that hold the rest of the leaf (a
            # worker-lead leaf's over ``data`` first, then over
            # ``model``): one stacked sum a subgroup, f32, rank order;
            # without cuts every leaf is whole and the squares are the sums
            if cuts is None:
                return sqs
            out = list(sqs)
            for axis, dims in ((("data", wdata.dims),)
                               if lead and wdata is not None else ()) + (
                    ("model", cuts.dims),):
                ks = [k for k, i in enumerate(ids) if dims[i] is not None]
                if ks:
                    tot = cuts.rm.sum_partials(
                        torch.stack([out[k] for k in ks]), "norms", axis)
                    for k, t in zip(ks, tot):
                        out[k] = t
            return out

        def momentum(m: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
            # (1-beta) M + beta g in f32: two products, then their sum
            if inplace and m.dtype == torch.float32:
                return m.mul_(1.0 - beta).add_(beta * g.to(torch.float32))
            return cast((1.0 - beta) * m.to(torch.float32)
                        + beta * g.to(torch.float32), m.dtype)

        def step(state: dict, grad_and_loss: Callable, batch: dict,
                 t) -> tuple[dict, dict]:
            plan = self.plan(cuts.params if cuts is not None
                             else server.params if chunked else state["x"],
                             metas)
            buckets = (plan.ns_buckets(mesh=mesh, fsdp=fsdp)
                       if cfg.ns_bucketing else ())
            bucketed = {i for b in buckets for i in b.leaf_ids}
            # both wire directions cut their buffers along one partition
            splan = resolve_stage_plan(cfg, plan,
                                       any_pack=pack_wire or pack_s2w,
                                       mesh=mesh, fsdp=fsdp)
            x_flat = plan.flatten(state["x"])
            dev = x_flat[0].device
            t32 = torch.as_tensor(t, dtype=torch.float32, device=dev)
            step_no = int(state["step"])
            nvtx = dev.type == "cuda"

            def span(name: str):
                return phase_span(name, cfg.trace_spans, nvtx)

            mset = MetricSet(dev) if cfg.metrics else None
            efp: list = []       # ‖X - W‖ per leaf, read before X moves
            # §13 reception: who hears this round's broadcast, the
            # schedule AND the drops (the guard does not gate it), so it
            # is known before any payload exists
            recv = ring = None
            if ring_depth or elastic:
                recv = mask_to_device(reception_mask(
                    cfg.participation, cfg.n_workers, step_no,
                    cfg.participation_seed, faults), dev)

            # ---- 1. EF21-P: the workers' model estimate W, advanced by
            # S = C_P(X - W). Packed, the server compresses only, packs S
            # into the s2w wire (lead dim 1: one message) and both ends
            # advance W from the wire bytes; unpacked, ef_compress_step's
            # own estimate, the same bits (pack -> unpack is bit-exact).
            # With resync the round's bytes also go into the replay ring
            w_l = cs_l = None
            with span(PHASE_SPANS[0]):
                if pack_s2w:
                    w_old = plan.flatten(state["w"])
                    s_payloads, cs_l = [], []
                    for i, (lp, cs, w, x) in enumerate(zip(
                            plan.leaves, state["cs_state"], w_old, x_flat)):
                        pl, cs = ef_compress(lp.s2w, cs, whole(i, w),
                                             whole(i, x), lp.slice_shape,
                                             cfg.wire_dtype,
                                             cut_kw(i).get("whole"))
                        s_payloads.append(_lead(pl, 1))
                        cs_l.append(cs)
                    w_l = [None] * len(plan.leaves)

                    def s2w_apply(i, pl):
                        lp = plan.leaves[i]
                        w_l[i] = apply_payload(
                            lp.s2w, _lead(pl, 0), w_old[i], donate,
                            shape=lp.shape,
                            part=(lambda d: local(i, d))
                            if chunked or cuts is not None else None)

                    if splan is not None:
                        # every stage's broadcast issued first, heaviest
                        # receive work first (§9), then each unpacked
                        swire = plan.staged_wire_layout(cfg.wire_dtype,
                                                        splan, "s2w")
                        sbufs = {}
                        for k in s2w_issue_order(plan, splan):
                            with span(wire_stage_span("s2w", k)):
                                sbufs[k] = reshard_updates(
                                    swire.pack_stage(k, s_payloads))
                        del s_payloads
                        if ring_depth:
                            # the received stage buffers in stage order,
                            # before each is unpacked and freed
                            ring = ring_push(
                                state["resync"]["ring"],
                                *(sbufs[k][0] for k in range(len(sbufs))),
                                inplace=inplace)
                        for k in list(sbufs):
                            for i, pl in zip(
                                    splan.stages[k].leaf_ids,
                                    swire.unpack_stage(k, sbufs.pop(k))):
                                s2w_apply(i, pl)
                    else:
                        swire = plan.wire_layout(cfg.wire_dtype, "s2w")
                        with span(wire_stage_span("s2w", 0)):
                            buf = reshard_updates(swire.pack(s_payloads))
                        del s_payloads
                        if ring_depth:
                            ring = ring_push(state["resync"]["ring"],
                                             buf[0], inplace=inplace)
                        for i, pl in enumerate(swire.unpack(buf)):
                            s2w_apply(i, pl)
                        del buf
                    del w_old
                elif cfg.s2w != "identity":
                    cs_l, w_l, s_payloads = [], [], []
                    for i, (lp, cs, w, x) in enumerate(zip(
                            plan.leaves, state["cs_state"],
                            plan.flatten(state["w"]), x_flat)):
                        pl, cs, w = ef_compress_step(lp.s2w, cs, whole(i, w),
                                                     whole(i, x),
                                                     lp.slice_shape,
                                                     cfg.wire_dtype, donate,
                                                     **cut_kw(i))
                        cs_l.append(cs)
                        w_l.append(local_data(i, w) if cuts is not None
                                   else local(i, w))
                        if ring_depth:
                            s_payloads.append(_lead(pl, 1))
                    if ring_depth:
                        # no wire here: the ring's row is the message
                        # packed through the monolithic s2w layout
                        ring = ring_push(state["resync"]["ring"],
                                         plan.wire_layout(
                                             cfg.wire_dtype, "s2w").pack(
                                                 s_payloads)[0],
                                         inplace=inplace)
                    del s_payloads
            if mset is not None and w_l is not None:
                # EF21-P model-estimate error ‖X - W‖, X before phase 5
                # (a cut leaf's squares summed over the model subgroup)
                def x_minus_w(i):
                    return (whole(i, x_flat[i]).to(torch.float32)
                            - whole(i, w_l[i]).to(torch.float32))

                ids = list(range(len(plan.leaves)))
                efp = [torch.sqrt(q) for q in summed(
                    ids, [norm_sq(x_minus_w(i), 0) for i in ids], 0)]

            # ---- §13 rejoin: bring every receiving worker's W_j current,
            # by replaying the ring's slots it missed while the round it
            # needs is still there (R-1 missed at most; in round order,
            # apply_payload's f32 add per slot, each slot decompressed
            # once), or else by a copy of the server's new W. Local work
            # only: no collective
            ww_l = rm = None
            if ring_depth:
                with span(RESYNC_SPAN):
                    rm = replay_masks(state["resync"]["vv"], step_no, recv,
                                      ring_depth)
                    ww_l = plan.flatten(state["w_w"])
                    ring_splan = splan if pack_s2w else None

                    def put_w(i, mask, new):
                        w = ww_l[i]
                        new = torch.where(mask_bcast(mask[lo], w.ndim), new,
                                          w)
                        ww_l[i] = w.copy_(new) if inplace else new

                    for r in range(ring_depth):
                        for i, pl in enumerate(_unpack_row(
                                plan, cfg, ring_splan, ring[r])):
                            lp = plan.leaves[i]
                            delta = wpart(i, lp.s2w.decompress(
                                _lead(pl, 0), lp.shape, torch.float32), 0)
                            put_w(i, rm.apply[r],
                                  cast(add_delta(lp.s2w,
                                                 ww_l[i].to(torch.float32),
                                                 delta), ww_l[i].dtype))
                            del delta
                    for i, w in enumerate(w_l):
                        w = whole(i, w)
                        if wdata is not None:
                            w = wdata.local(i, w)
                        put_w(i, rm.full, cast(w, ww_l[i].dtype)[None])

            # ---- 2. per-worker stochastic gradients at W (with resync at
            # each worker's own W_j, one cast of it alive at a time), in
            # the params' dtype (XLA's rounding: ``cast``)
            with span(PHASE_SPANS[1]):
                # W whole for this rank's workers: gathered in the
                # params' dtype where the state holds chunks
                if w_l is None:
                    w_at = (plan.unflatten([whole(i, x) for i, x in
                                            enumerate(x_flat)])
                            if chunked else state["x"])
                elif ww_l is None:
                    w_at = plan.unflatten(
                        [whole(i, cast(w, x.dtype))
                         for i, (w, x) in enumerate(zip(w_l, x_flat))])
                else:
                    w_at = None    # each worker's W_j, cast in its turn
                losses, grads_w = [], []
                for j in range(len(workers)):     # this rank's workers
                    w_j = w_at if ww_l is None else plan.unflatten(
                        [cast(w[j], x.dtype) if wdata is None else
                         wdata.whole(i, cast(w[j], x.dtype))
                         for i, (w, x) in enumerate(zip(ww_l, x_flat))])
                    loss, grads = grad_and_loss(
                        w_j, {k: v[j] for k, v in batch.items()})
                    del w_j
                    losses.append(loss)
                    grads_w.append(plan.flatten(grads))
                del w_at
                grads = [torch.stack(g) for g in zip(*grads_w)]
                del grads_w
                if wdata is not None:
                    # the worker-lead leaves' chunks over ``data``
                    grads = [wdata.local(i, g, 1) for i, g in
                             enumerate(grads)]
                if faults is not None:
                    # poisoned gradient leaves (§11): they flow through
                    # momentum into the payload, where the guard demotes
                    # the worker; the losses stay clean
                    grads = faults.inject_grads(grads, step_no, workers)

            # ---- 3. momentum + EF21 per worker: R_j = C_D(M_j - G_j)
            with span(PHASE_SPANS[2]):
                gw_old = plan.flatten(state["g_w"])
                if state["m_w"] is not None:
                    m_new = [momentum(m, g) for m, g in
                             zip(plan.flatten(state["m_w"]), grads)]
                else:
                    m_new = [g.to(cfg.state_dtype) for g in grads]
                del grads
                # ‖v‖ = ‖M_j - G_j‖ per worker, read before G_j moves
                # (an elastic step reads it after its commit instead)
                # (the rank's squares, summed with the rest's below)
                v_norms = ([norm_sq(m.to(torch.float32)
                                    - g.to(torch.float32))
                            for m, g in zip(m_new, gw_old)]
                           if mset is not None and not elastic else None)
                payloads, cw_l, gw_l = [], [], []
                for i, (lp, cw, gw, m) in enumerate(zip(
                        plan.leaves, state["cw_state"], gw_old, m_new)):
                    pl, cw, gw = ef_compress_step(
                        lp.w2s, cw, gw, m, lp.slice_shape, cfg.wire_dtype,
                        inplace, **cut_kw(i, 1, (len(workers),)))
                    payloads.append(pl)
                    cw_l.append(cw)
                    gw_l.append(gw)

            # ---- 4.+5. server receive G += mean_j decompress(R_j) (the
            # participants' mean, elastic), then the layer-wise LMO on the
            # server iterate; with ns_bucketing the spectral leaves run
            # one batched Newton-Schulz chain per shape bucket (§7)
            gsrv_l = plan.flatten(state["g_server"])
            gs_l: list = [None] * len(plan.leaves)
            x_l: list = [None] * len(plan.leaves)
            # ‖g_server‖² a leaf, taken where the LMO holds it whole
            gsq: list = [None] * len(plan.leaves)

            def resolve_mask(recv_payloads):
                """(mask, fold denominator, any participant, demoted):
                the reception mask ANDed with payload finiteness, the
                count on the device."""
                m = recv
                demoted = torch.zeros((), dtype=torch.int64, device=dev)
                if guard:
                    finite = payload_finite_mask(recv_payloads,
                                                 cfg.n_workers, dev)
                    demoted = torch.sum(m & ~finite)
                    m = m & finite
                cnt = torch.sum(m)
                return (m, torch.clamp(cnt, min=1).to(torch.float32),
                        cnt > 0, demoted)

            def recv_leaf(i, pl, part=None):
                # the fold through fold_f32: the reference's sum, its
                # mean's fused multiply-add (or the elastic division) and
                # its NaN bits, on the card as on the CPU
                lp, gs = plan.leaves[i], gsrv_l[i]
                d = local(i, lp.w2s.decompress(pl, (cfg.n_workers,)
                                               + lp.shape, torch.float32),
                          lead=1)
                if part is not None:
                    # the participants' sum over their dynamic count;
                    # where (not a product), so a demoted worker's NaNs
                    # never reach the sum
                    d = torch.where(mask_bcast(part[0], d.ndim), d, 0.0)
                    gs_l[i] = cast(fold_f32(gs.to(torch.float32),
                                            d.contiguous(), part[1]),
                                   gs.dtype)
                elif inplace and gs.dtype == torch.float32:
                    gs_l[i] = fold_f32(gs, d.contiguous(), cfg.n_workers,
                                       out=gs)
                else:
                    gs_l[i] = cast(fold_f32(gs.to(torch.float32),
                                            d.contiguous(), cfg.n_workers),
                                   gs.dtype)

            def put_x(i, new):
                # contiguous either way (a bucket member may come back
                # transposed): the next forward then reads the same
                # layouts, and so the same bits on the card, donated or not
                x_l[i] = (x_flat[i].copy_(new) if inplace
                          else new.to(x_flat[i].dtype).contiguous())

            def whole_g(i):
                g = whole(i, gs_l[i])
                if chunked or cuts is not None:
                    # over a model cut, the chunk's part of the sum
                    gsq[i] = torch.sum(torch.square(g.to(torch.float32)))
                return g

            def lmo_leaf(i):
                lp = plan.leaves[i]
                if cuts is not None and cuts.dims[i] is not None \
                        and lp.meta.lmo != "sign":
                    # a cut leaf's LMO on its gradient gathered whole (the
                    # sign LMO is elementwise: it runs on the chunk)
                    d = local(i, per_slice(
                        lambda g: lmo_direction(g, lp.meta.lmo,
                                                ns_steps=cfg.ns_steps),
                        lp.meta.stack_dims,
                        cuts.whole(i, whole_g(i), "lmo_in")))
                    radius = t32 * lp.meta.radius_scale
                    put_x(i, (x_flat[i].to(torch.float32)
                              + radius * d.to(torch.float32)))
                    return

                def one(x, g):
                    d = lmo_direction(g, lp.meta.lmo, ns_steps=cfg.ns_steps)
                    radius = t32 * lp.meta.radius_scale
                    return (x.to(torch.float32)
                            + radius * d.to(torch.float32)).to(x.dtype)

                out = per_slice(one, lp.meta.stack_dims, whole(i, x_flat[i]),
                                whole_g(i))
                # over a model cut x and g are the rank's chunks already
                put_x(i, local_data(i, out) if cuts is not None
                      else local(i, out))

            def lmo_bucket_cut(bi, b):
                """Bucket ``b``'s LMO on the rank's chunks (``cuts``): a
                stack whose columns are cut on ``model`` runs the chain on
                the rank's columns (``newton_schulz_cols``: gram partials
                summed over the model subgroup); any other gathers its
                members whole over ``model`` and runs the whole chain.
                Either splits its slices over the batch dim's axes where
                the spec puts them (``split_rows``: any axis of the mesh
                or a composition, pod-major) and gathers the direction's
                rows back (``ns_rows``); each member then moves its chunk
                of x. With metrics, the residual of every slice (a column
                cut's grams summed over the model subgroup), gathered
                from the ranks that ran them."""
                rm = cuts.rm
                lead, _, col = b.pspec or (None, None, None)
                rows = split_rows(b.batch, pspec=b.pspec, mesh=rm)
                if col == "model":
                    def cols(i, tr, g):
                        # an uncut member's columns of the rank
                        return g if cuts.dims[i] is not None else \
                            rm.chunk(g, g.ndim - 2 if tr else g.ndim - 1)

                    g_b = b.stack([cols(i, tr, whole_g(i)) for i, tr in
                                   zip(b.leaf_ids, b.transposes)])
                    d_b = -newton_schulz_cols(
                        g_b, lambda t: rm.sum_partials(t, "gram"), rows,
                        cfg.ns_steps)
                else:
                    g_b = b.stack([cuts.whole(i, whole_g(i), "ns_rows")
                                   for i in b.leaf_ids])
                    d_b = -newton_schulz_rows(g_b, rows, cfg.ns_steps)
                del g_b
                if mset is not None:
                    res = orth_residual_slices(
                        d_b, (lambda g: rm.sum_partials(g, "gram"))
                        if col == "model" else None)
                    if rows is not None:
                        res = rm.gather(res, 0, "norms", lead)
                    m_, n_ = b.shape
                    mset.add(f"ns/orth_residual/b{bi}_{m_}x{n_}",
                             torch.mean(res))
                if rows is not None:
                    d_b = rm.gather(d_b.contiguous(), 0, "ns_rows", lead)
                rv = b.radius_vector(t32, dev)
                off = 0
                for i, tr, cnt in zip(b.leaf_ids, b.transposes, b.counts):
                    piece = d_b[off:off + cnt]
                    radius = rv[off]    # one radius a member
                    off += cnt
                    whole_piece = col != "model" or cuts.dims[i] is None
                    if col == "model" and cuts.dims[i] is None:
                        piece = rm.gather(piece.contiguous(), -1, "ns_rows")
                    if tr:
                        piece = piece.transpose(-1, -2)
                    piece = (local(i, piece.reshape(cuts.shapes[i]))
                             if whole_piece else local_data(
                                 i, piece.reshape(cuts.local_shape(i))))
                    put_x(i, x_flat[i].to(torch.float32)
                          + radius * piece.to(torch.float32))

            def lmo_bucket(bi, b):
                if cuts is not None:
                    lmo_bucket_cut(bi, b)
                    return
                g_b = b.stack([whole_g(i) for i in b.leaf_ids])
                # a bucket the group divides: this rank's rows only
                rows = split_rows(b.batch, group, b.pspec)
                d_b = lmo_direction_batched(g_b, ns_steps=cfg.ns_steps,
                                            group=group, pspec=b.pspec,
                                            gather=False)
                del g_b
                if mset is not None:
                    # NS orthogonality residual per bucket (§10): the
                    # mean over every slice, whichever rank ran it
                    res = orth_residual_slices(d_b)
                    if rows is not None:
                        res = server.gather_values(res)
                    m_, n_ = b.shape
                    mset.add(f"ns/orth_residual/b{bi}_{m_}x{n_}",
                             torch.mean(res))
                x_b = b.stack([whole(i, x_flat[i]) for i in b.leaf_ids],
                              dtype=torch.float32)
                rv = b.radius_vector(t32, dev)
                if rows is not None:
                    x_b = x_b[rows.start:rows.stop]
                    rv = rv[rows.start:rows.stop]
                x_b = x_b + rv[:, None, None] * d_b.to(torch.float32)
                del d_b
                if rows is not None:
                    # the rows in x's dtype (half the f32 direction's
                    # bytes) to the ranks that hold them
                    xds = {x_flat[i].dtype for i in b.leaf_ids}
                    xd = xds.pop() if len(xds) == 1 else torch.float32
                    x_b = server.share_rows(x_b.to(xd), b)
                for i, piece in zip(b.leaf_ids, b.unstack(x_b)):
                    put_x(i, local(i, piece))

            part = None
            if pack_wire and splan is not None:
                # staged wire (§8): all K sub-buffers gathered first, then
                # each stage's unpack -> fold -> LMO consumes only its own
                # sub-buffer, biggest NS buckets first
                swire = plan.staged_wire_layout(cfg.wire_dtype, splan)
                bufs = []
                with span(PHASE_SPANS[3]):
                    for k in range(splan.n_stages):
                        with span(wire_stage_span("w2s", k)):
                            buf = reshard_payloads(
                                swire.pack_stage(k, payloads))
                            if faults is not None:
                                buf = faults.inject_wire(buf, step_no, k,
                                                         "w2s")
                            bufs.append(buf)
                del payloads
                staged: list = [None] * len(plan.leaves)
                if elastic:
                    # the guard's demotion is a step-global decision:
                    # every stage unpacks before the first fold
                    with span(PHASE_SPANS[3]):
                        for k, stage in enumerate(splan.stages):
                            for i, pl in zip(stage.leaf_ids,
                                             swire.unpack_stage(k, bufs[k])):
                                staged[i] = pl
                        part = resolve_mask(staged)
                for k, stage in enumerate(splan.stages):
                    with span(PHASE_SPANS[3]):
                        pls = ([staged[i] for i in stage.leaf_ids]
                               if elastic
                               else swire.unpack_stage(k, bufs[k]))
                        for i, pl in zip(stage.leaf_ids, pls):
                            recv_leaf(i, pl, part)
                            staged[i] = None
                        del pls
                        bufs[k] = None
                    with span(PHASE_SPANS[4]):
                        for bi in stage.bucket_ids:
                            lmo_bucket(bi, buckets[bi])
                        for i in stage.leaf_ids:
                            if i not in bucketed:  # stage-0 eager leaves
                                lmo_leaf(i)
            else:
                # monolithic: one buffer through the hook, or no wire
                with span(PHASE_SPANS[3]):
                    if pack_wire:
                        wire = plan.wire_layout(cfg.wire_dtype)
                        with span(wire_stage_span("w2s", 0)):
                            buf = reshard_payloads(wire.pack(payloads))
                            if faults is not None:
                                buf = faults.inject_wire(buf, step_no, 0,
                                                         "w2s")
                        payloads = wire.unpack(buf)
                        del buf
                    elif reshard_payloads is not None:
                        payloads = reshard_payloads(payloads)
                    part = resolve_mask(payloads) if elastic else None
                    for i, pl in enumerate(payloads):
                        recv_leaf(i, pl, part)
                    del payloads
                with span(PHASE_SPANS[4]):
                    for i in range(len(plan.leaves)):
                        if i not in bucketed:
                            lmo_leaf(i)
                    for bi, b in enumerate(buckets):
                        lmo_bucket(bi, b)

            if elastic:
                # ---- §11 commit: absent and demoted workers' G_j, M_j
                # and compressor states stay bit for bit; with no
                # participant the step is skipped: X and g_server stay
                # (the fold added 0, but the LMO of a stale g must not be
                # walked). All on the device: no host branch.
                effm, _, any_p, n_demoted = part

                def freeze(new, old):
                    # this rank's workers' rows of the global mask
                    if isinstance(new, dict):
                        return {k: freeze(new[k], old[k]) for k in new}
                    if not isinstance(new, torch.Tensor):
                        return new
                    return torch.where(mask_bcast(effm[lo], new.ndim), new,
                                       old)

                gw_l = [freeze(n, o) for n, o in zip(gw_l, gw_old)]
                cw_l = [freeze(n, o) for n, o in zip(cw_l,
                                                     state["cw_state"])]
                if state["m_w"] is not None:
                    m_new = [freeze(n, o) for n, o in
                             zip(m_new, plan.flatten(state["m_w"]))]
                x_l = [torch.where(any_p, xn, xo)
                       for xn, xo in zip(x_l, x_flat)]
                gs_l = [torch.where(any_p, gn, go)
                        for gn, go in zip(gs_l, gsrv_l)]
                if mset is not None:
                    mset.add("part/n_participants",
                             torch.sum(effm.to(torch.float32)))
                    mset.add("part/demoted", n_demoted.to(torch.float32))
                    mset.add("part/skipped_step",
                             1.0 - any_p.to(torch.float32))

            # ---- the per-worker scalars, gathered once: the losses and,
            # with metrics, per leaf ‖M_j - G_j'‖, ‖v‖ = ‖M_j - G_j‖ and
            # ‖M_j‖, so every rank reduces over all workers in order
            cols = [torch.stack(losses).to(torch.float32)]
            if mset is not None:
                for i in range(len(plan.leaves)):
                    cols.append(norm_sq(m_new[i].to(torch.float32)
                                        - gw_l[i].to(torch.float32)))
                    cols.append(v_norms[i] if v_norms is not None else
                                norm_sq(m_new[i].to(torch.float32)
                                        - gw_old[i].to(torch.float32)))
                    cols.append(norm_sq(m_new[i]))
                # the squares summed over any cuts, then their roots
                cols[1:] = [torch.sqrt(q) for q in summed(
                    [i for i in range(len(plan.leaves)) for _ in range(3)],
                    cols[1:])]
            scal = torch.stack(cols, dim=1)
            if gather_scalars is not None:
                scal = gather_scalars(scal)
            col = lambda c: scal[:, c].contiguous()  # noqa: E731

            if mset is not None:
                # per-leaf EF21 telemetry (§10), pure reads: v = M_j - G_j
                # is the compressed target, C(v) = G_j' - G_j the message,
                # so ‖M_j - G_j'‖ is the post-update error and the
                # compression residual at once
                for i, nm in enumerate(leaf_names(state["x"])):
                    err, v = col(1 + 3 * i), col(2 + 3 * i)
                    mset.add(f"ef/err_norm/{nm}", torch.mean(err))
                    mset.add(f"ef/rel_err/{nm}", rel_error_of_norms(err, v))
                    mset.add(f"ef/momentum_norm/{nm}",
                             torch.mean(col(3 + 3 * i)))
                    if efp:
                        mset.add(f"efp/err_norm/{nm}", efp[i])
                mset.add("wire/bytes_w2s",
                         plan.wire_layout(cfg.wire_dtype).total_nbytes)
                mset.add("wire/bytes_s2w",
                         plan.wire_layout(cfg.wire_dtype, "s2w").total_nbytes
                         if cfg.s2w != "identity" else 0.0)
                mset.add("wire/n_stages",
                         splan.n_stages if splan is not None else 1)
                if rm is not None:
                    # §13 rejoin telemetry, reads of the replay masks
                    mset.add("part/worker_version_lag_max",
                             rm.lag_max.to(torch.float32))
                    mset.add("resync/replayed",
                             rm.n_replayed.to(torch.float32))
                    mset.add("resync/full", rm.n_full.to(torch.float32))

            new_state = {
                "step": state["step"] + 1,
                "x": plan.unflatten(x_l),
                "g_server": plan.unflatten(gs_l),
                "g_w": plan.unflatten(gw_l),
                "m_w": (plan.unflatten(m_new) if state["m_w"] is not None
                        else None),
                "cw_state": cw_l,
            }
            if w_l is not None:
                new_state["w"] = plan.unflatten(w_l)
                new_state["cs_state"] = cs_l
            if rm is not None:
                # W_j, the version vector and the ring advance even on a
                # skipped step: the server's W advanced, and the broadcast
                # stream must stay contiguous
                new_state["w_w"] = plan.unflatten(ww_l)
                new_state["resync"] = {"vv": rm.vv_new, "ring": ring}
            # chunked: each leaf's sum as the LMO took it whole; a
            # skipped step's old g_server differs from the folded one by
            # + 0.0 at most (a -0.0 turned +0.0), which squares alike
            if cuts is not None:
                # the cut leaves' squares (as the LMO took each, whole over
                # data) summed over the model subgroup
                cut_sq = [q for q, d in zip(gsq, cuts.dims) if d is not None]
                gsq = [q for q, d in zip(gsq, cuts.dims) if d is None]
                if cut_sq:
                    gsq.append(cuts.rm.sum_partials(torch.stack(cut_sq),
                                                    "norms").sum())
            aux = {"loss": torch.mean(col(0)),
                   "grad_est_norm": torch.sqrt(sum(
                       gsq if chunked or cuts is not None else
                       (torch.sum(torch.square(g.to(torch.float32)))
                        for g in gs_l)))}
            if elastic:
                aux["participation"] = part[0]
                aux["n_participants"] = torch.sum(part[0])
                aux["skipped"] = ~part[2]
            if rm is not None:
                aux["resync_replayed"] = rm.n_replayed
                aux["resync_full"] = rm.n_full
                aux["version_lag_max"] = rm.lag_max
            if mset is not None:
                aux["metrics"] = mset
            return new_state, aux

        return step
