"""EF21-Muon — the paper's contribution (Algorithms 1-3) in PyTorch.

Port of ``repro/core/muon.py`` on one process with full participation:
the bidirectional step of ``muon.py:461-823``, phases 1-5.

    opt   = EF21Muon(cfg)
    state = opt.init(generator, params, metas)
    step  = opt.make_step(metas, reshard_payloads=None,
                          reshard_updates=None)
    state, aux = step(state, grad_and_loss, batch, t)

``grad_and_loss(params, batch_slice) -> (loss, grads)`` and every batch
entry has a leading worker dimension of size ``cfg.n_workers``; each
worker gets its own autograd pass. The worker dimension leads every
per-worker state tensor, as in the reference state.

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
What the reference has beyond this (metrics, elastic participation,
resync, faults) raises here instead of being ignored.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.dist.layerwise import (LayerPlan, leaf_paths, per_slice,
                                       tree_leaves)
from repro_torch.dist.pipeline import s2w_issue_order
from repro_torch.wire.codecs import flatten_payload, unflatten_payload

from .error_feedback import apply_payload, cast, ef_compress, ef_compress_step
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
    # beyond this slice: make_step raises unless they hold these values
    metrics: bool = False          # ROADMAP Queue 1 item 8
    participation: str = "full"    # ROADMAP Queue 1 item 8
    resync: Any = None             # ROADMAP Queue 1 item 8


def _unsupported(cfg: EF21MuonConfig, faults) -> str | None:
    if cfg.metrics:
        return "metrics=True: the MetricSet is ROADMAP Queue 1 item 8"
    if cfg.participation != "full":
        return (f"participation={cfg.participation!r}: elastic "
                "participation is ROADMAP Queue 1 item 8")
    if cfg.resync:
        return "resync: desynchronized-worker rejoin is ROADMAP Queue 1 item 8"
    if faults is not None:
        return "faults: the fault plan is ROADMAP Queue 1 item 8"
    return None


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
                       any_pack: bool = True):
    """The resolved stage partition (§8), or None when the pipeline
    collapses to the monolithic single-gather path: staging needs a
    packed direction, NS bucketing, ``wire_stages != 1`` and more than
    one effective stage."""
    if not (any_pack and cfg.ns_bucketing and cfg.wire_stages != 1):
        return None
    sp = plan.stage_plan(wire_stages=cfg.wire_stages, ns_steps=cfg.ns_steps)
    return sp if sp.n_stages > 1 else None


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
             metas: Any) -> dict:
        """Optimizer state on the params' device. ``generator`` (a CPU
        ``torch.Generator``) draws the compressor states: RankK's
        sketches ``q``, ``[n_workers, *stack, n, r]`` per leaf in
        ``cw_state``, all of ``cw_state`` first, in leaf order (Identity,
        TopK and Natural keep none, and take None). A compressing s2w
        leg adds the workers' model estimate ``w`` (the params in
        ``state_dtype``) and the server's compressor states ``cs_state``,
        ``[*stack, n, r]`` per leaf."""
        cfg = self.cfg
        sd = cfg.state_dtype
        plan = self.plan(params, metas)
        x_l = plan.flatten(params)
        per_worker = lambda p: torch.zeros((cfg.n_workers,) + tuple(p.shape),
                                           dtype=sd, device=p.device)
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
            "cw_state": [lp.w2s.init(generator, lp.slice_shape,
                                     cfg.wire_dtype,
                                     (cfg.n_workers,) + lp.stack_shape,
                                     p.device)
                         for lp, p in zip(plan.leaves, x_l)],
        }
        if cfg.s2w != "identity":
            state["w"] = plan.unflatten([p.to(sd, copy=True) for p in x_l])
            # the server's one message per stack slice: [*stack]
            state["cs_state"] = [lp.s2w.init(generator, lp.slice_shape,
                                             cfg.wire_dtype, lp.stack_shape,
                                             p.device)
                                 for lp, p in zip(plan.leaves, x_l)]
        return state

    # ------------------------------------------------------------ bookkeeping
    def wire_bytes_per_worker(self, params: Any, metas: Any) -> int:
        """Exact bytes of one worker's uint8 wire buffer — what the
        payload all-gather moves per worker."""
        return self.plan(params, metas).wire_layout(
            self.cfg.wire_dtype).total_nbytes

    def wire_budget(self, params: Any, metas: Any,
                    distributed: bool = True) -> WireBudget:
        """The :class:`WireBudget` of ``make_step``'s phases 1 and 4 on
        ``params``, through the same switches the step uses.
        ``distributed=False`` is the hook-less step (nothing packed)."""
        cfg = self.cfg
        plan = self.plan(params, metas)
        pack_w2s = bool(cfg.wire_pack and distributed)
        pack_s2w = resolve_pack_s2w(cfg, distributed)
        splan = resolve_stage_plan(cfg, plan, any_pack=pack_w2s or pack_s2w)

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
                  faults=None) -> Callable:
        """Returns ``step(state, grad_and_loss, batch, t) -> (state, aux)``;
        raises on what it does not run. ``reshard_payloads`` is the
        worker->server hook: it gets each ``[n_workers, nbytes]`` uint8
        wire (sub-)buffer (or, with ``wire_pack=False``, the list of
        per-leaf payloads) and returns what every worker received.
        ``reshard_updates`` is the server->worker hook: it gets each
        ``[1, nbytes]`` uint8 s2w (sub-)buffer, the server's one message,
        and returns what every worker received, of the same shape; it
        defaults to ``reshard_payloads``, which suits only a hook that
        returns its input (a one-process test). A collective must come
        as ``reshard_updates``: an all-gather in its place would return
        ``[n_ranks, nbytes]`` and count the message as gathered bytes.
        None for both means single-process: nothing is packed."""
        cfg = self.cfg
        why = _unsupported(cfg, faults)
        if why is not None:
            raise NotImplementedError(f"repro_torch EF21Muon: {why}")
        pack_wire = cfg.wire_pack and reshard_payloads is not None
        if reshard_updates is None:
            reshard_updates = reshard_payloads
        pack_s2w = resolve_pack_s2w(cfg, reshard_updates is not None)

        def step(state: dict, grad_and_loss: Callable, batch: dict,
                 t) -> tuple[dict, dict]:
            plan = self.plan(state["x"], metas)
            buckets = plan.ns_buckets() if cfg.ns_bucketing else ()
            bucketed = {i for b in buckets for i in b.leaf_ids}
            # both wire directions cut their buffers along one partition
            splan = resolve_stage_plan(cfg, plan,
                                       any_pack=pack_wire or pack_s2w)
            x_flat = plan.flatten(state["x"])
            dev = x_flat[0].device
            t32 = torch.as_tensor(t, dtype=torch.float32, device=dev)

            # ---- 1. EF21-P: the workers' model estimate W, advanced by
            # S = C_P(X - W). Packed, the server compresses only, packs S
            # into the s2w wire (lead dim 1: one message) and both ends
            # advance W from the wire bytes; unpacked, ef_compress_step's
            # own estimate, the same bits (pack -> unpack is bit-exact)
            w_l = cs_l = None
            if pack_s2w:
                w_old = plan.flatten(state["w"])
                s_payloads, cs_l = [], []
                for lp, cs, w, x in zip(plan.leaves, state["cs_state"],
                                        w_old, x_flat):
                    pl, cs = ef_compress(lp.s2w, cs, w, x, lp.slice_shape,
                                         cfg.wire_dtype)
                    names, leaves = flatten_payload(pl)
                    s_payloads.append(unflatten_payload(
                        names, [a[None] for a in leaves]))
                    cs_l.append(cs)
                w_l = [None] * len(plan.leaves)

                def s2w_apply(i, pl):
                    names, leaves = flatten_payload(pl)
                    w_l[i] = apply_payload(
                        plan.leaves[i].s2w,
                        unflatten_payload(names, [a[0] for a in leaves]),
                        w_old[i])

                if splan is not None:
                    # every stage's broadcast issued first, heaviest
                    # receive work first (§9), then each unpacked
                    swire = plan.staged_wire_layout(cfg.wire_dtype, splan,
                                                    "s2w")
                    order = s2w_issue_order(plan, splan)
                    sbufs = {k: reshard_updates(swire.pack_stage(
                        k, s_payloads)) for k in order}
                    del s_payloads
                    for k in order:
                        for i, pl in zip(splan.stages[k].leaf_ids,
                                         swire.unpack_stage(k, sbufs.pop(k))):
                            s2w_apply(i, pl)
                else:
                    swire = plan.wire_layout(cfg.wire_dtype, "s2w")
                    buf = reshard_updates(swire.pack(s_payloads))
                    del s_payloads
                    for i, pl in enumerate(swire.unpack(buf)):
                        s2w_apply(i, pl)
                    del buf
                del w_old
            elif cfg.s2w != "identity":
                cs_l, w_l = [], []
                for lp, cs, w, x in zip(plan.leaves, state["cs_state"],
                                        plan.flatten(state["w"]), x_flat):
                    _, cs, w = ef_compress_step(lp.s2w, cs, w, x,
                                                lp.slice_shape,
                                                cfg.wire_dtype)
                    cs_l.append(cs)
                    w_l.append(w)

            # ---- 2. per-worker stochastic gradients at W, in the
            # params' dtype (XLA's rounding: ``cast``)
            w_at = state["x"] if w_l is None else plan.unflatten(
                [cast(w, x.dtype) for w, x in zip(w_l, x_flat)])
            losses, grads_w = [], []
            for j in range(cfg.n_workers):
                loss, grads = grad_and_loss(
                    w_at, {k: v[j] for k, v in batch.items()})
                losses.append(loss)
                grads_w.append(plan.flatten(grads))
            del w_at
            grads = [torch.stack(g) for g in zip(*grads_w)]
            del grads_w

            # ---- 3. momentum + EF21 per worker: R_j = C_D(M_j - G_j)
            beta = cfg.beta
            if state["m_w"] is not None:
                m_new = [cast((1.0 - beta) * m.to(torch.float32)
                              + beta * g.to(torch.float32), m.dtype)
                         for m, g in zip(plan.flatten(state["m_w"]), grads)]
            else:
                m_new = [g.to(cfg.state_dtype) for g in grads]
            del grads
            payloads, cw_l, gw_l = [], [], []
            for lp, cw, gw, m in zip(plan.leaves, state["cw_state"],
                                     plan.flatten(state["g_w"]), m_new):
                pl, cw, gw = ef_compress_step(lp.w2s, cw, gw, m,
                                              lp.slice_shape, cfg.wire_dtype)
                payloads.append(pl)
                cw_l.append(cw)
                gw_l.append(gw)

            # ---- 4.+5. server receive G += mean_j decompress(R_j), then
            # the layer-wise LMO on the server iterate; with ns_bucketing
            # the spectral leaves run one batched Newton-Schulz chain per
            # shape bucket (§7)
            gsrv_l = plan.flatten(state["g_server"])
            gs_l: list = [None] * len(plan.leaves)
            x_l: list = [None] * len(plan.leaves)

            def recv_leaf(i, pl):
                lp, gs = plan.leaves[i], gsrv_l[i]
                d = lp.w2s.decompress(pl, (cfg.n_workers,) + lp.shape,
                                      torch.float32)
                gs_l[i] = cast(gs.to(torch.float32) + torch.mean(d, dim=0),
                               gs.dtype)

            def lmo_leaf(i):
                lp = plan.leaves[i]

                def one(x, g):
                    d = lmo_direction(g, lp.meta.lmo, ns_steps=cfg.ns_steps)
                    radius = t32 * lp.meta.radius_scale
                    return (x.to(torch.float32)
                            + radius * d.to(torch.float32)).to(x.dtype)

                x_l[i] = per_slice(one, lp.meta.stack_dims, x_flat[i],
                                   gs_l[i])

            def lmo_bucket(b):
                g_b = b.stack([gs_l[i] for i in b.leaf_ids])
                d_b = lmo_direction_batched(g_b, ns_steps=cfg.ns_steps)
                x_b = b.stack([x_flat[i] for i in b.leaf_ids],
                              dtype=torch.float32)
                x_b = x_b + (b.radius_vector(t32, dev)[:, None, None]
                             * d_b.to(torch.float32))
                for i, piece in zip(b.leaf_ids, b.unstack(x_b)):
                    x_l[i] = piece.to(x_flat[i].dtype)

            if pack_wire and splan is not None:
                # staged wire (§8): all K sub-buffers gathered first, then
                # each stage's unpack -> fold -> LMO consumes only its own
                # sub-buffer, biggest NS buckets first
                swire = plan.staged_wire_layout(cfg.wire_dtype, splan)
                bufs = [reshard_payloads(swire.pack_stage(k, payloads))
                        for k in range(splan.n_stages)]
                del payloads
                for k, stage in enumerate(splan.stages):
                    for i, pl in zip(stage.leaf_ids,
                                     swire.unpack_stage(k, bufs[k])):
                        recv_leaf(i, pl)
                    bufs[k] = None
                    for bi in stage.bucket_ids:
                        lmo_bucket(buckets[bi])
                    for i in stage.leaf_ids:
                        if i not in bucketed:      # stage-0 eager leaves
                            lmo_leaf(i)
            else:
                # monolithic: one buffer through the hook, or no wire
                if pack_wire:
                    wire = plan.wire_layout(cfg.wire_dtype)
                    payloads = wire.unpack(reshard_payloads(
                        wire.pack(payloads)))
                elif reshard_payloads is not None:
                    payloads = reshard_payloads(payloads)
                for i, pl in enumerate(payloads):
                    recv_leaf(i, pl)
                del payloads
                for i in range(len(plan.leaves)):
                    if i not in bucketed:
                        lmo_leaf(i)
                for b in buckets:
                    lmo_bucket(b)

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
            aux = {"loss": torch.mean(torch.stack(losses)),
                   "grad_est_norm": torch.sqrt(sum(
                       torch.sum(torch.square(g.to(torch.float32)))
                       for g in gs_l))}
            return new_state, aux

        return step
