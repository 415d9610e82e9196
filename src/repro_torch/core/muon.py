"""EF21-Muon — the paper's contribution (Algorithms 1-3) in PyTorch.

Port of ``repro/core/muon.py`` on one process: full participation and
the identity server->worker leg (``s2w="identity"``, so the workers'
model estimate W is X itself). Phases 2-5 are those of
``muon.py:615-823``:

    opt   = EF21Muon(cfg)
    state = opt.init(generator, params, metas)
    step  = opt.make_step(metas, reshard_payloads=None)
    state, aux = step(state, grad_and_loss, batch, t)

``grad_and_loss(params, batch_slice) -> (loss, grads)`` and every batch
entry has a leading worker dimension of size ``cfg.n_workers``; each
worker gets its own autograd pass. The worker dimension leads every
per-worker state tensor, as in the reference state.

``reshard_payloads`` is the worker->server communication hook (the
trainer's all-gather over its process group). With it and
``cfg.wire_pack``, phase 4 packs the payloads into the uint8 wire
(``repro_torch.wire``), hands each buffer to the hook and unpacks what
comes back: staged (one buffer per wire stage, all issued before the
first is consumed, DESIGN.md §8) or monolithic (one buffer,
``wire_stages=1``). Pack -> unpack is bit-exact, so both arms are
bit-equal to the hook-less step, which packs nothing (as
``muon.py:404``). What the reference has beyond this slice (metrics,
elastic participation, resync, faults, a compressing s2w leg) raises
here instead of being ignored.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.dist.layerwise import LayerPlan, leaf_paths, tree_leaves

from .error_feedback import cast, ef_compress_step
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
    # beyond this slice: make_step raises unless they hold these values
    metrics: bool = False          # ROADMAP Queue 1 item 8
    participation: str = "full"    # ROADMAP Queue 1 item 8
    resync: Any = None             # ROADMAP Queue 1 item 8


def _unsupported(cfg: EF21MuonConfig, faults) -> str | None:
    if cfg.s2w != "identity":
        return (f"s2w={cfg.s2w!r}: the EF21-P server->worker leg is ROADMAP "
                "Queue 1 item 4 (s2w compressors)")
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


def _per_slice(fn: Callable, stack_dims: int, *xs: torch.Tensor
               ) -> torch.Tensor:
    """``fn`` on every slice of the leading ``stack_dims`` dims (the
    reference's ``vmap_n``), results stacked back."""
    if stack_dims == 0:
        return fn(*xs)
    shape = xs[0].shape
    flat = [x.reshape((-1,) + tuple(x.shape[stack_dims:])) for x in xs]
    outs = [fn(*s) for s in zip(*flat)]
    return torch.stack(outs).reshape(shape)


@dataclass(frozen=True)
class WireBudget:
    """The static per-step collective budget of the wire: exactly
    ``len(w2s_sizes)`` worker->server u8 all-gathers, each moving its
    listed bytes per worker (one entry per stage sub-buffer; monolithic
    => one entry; unpacked => none). The s2w fields stay empty until the
    EF21-P leg is ported (ROADMAP Queue 1 item 4); they keep the
    reference's shape of this record."""
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
        """The LayerPlan for these (shapes, dtypes, metas), cached LRU
        (8 entries, oldest dropped first)."""
        leaves = tree_leaves(params)
        key = (tuple(leaf_paths(params)),
               tuple(tuple(p.shape) for p in leaves),
               tuple(str(p.dtype) for p in leaves), tuple(tree_leaves(metas)))
        if key in self._plans:
            self._plans.move_to_end(key)
        else:
            if len(self._plans) >= 8:
                self._plans.popitem(last=False)
            self._plans[key] = LayerPlan.build(params, metas, w2s=self.cfg.w2s)
        return self._plans[key]

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator | None, params: Any,
             metas: Any) -> dict:
        """Optimizer state on the params' device. ``generator`` seeds
        compressor states (Identity and TopK keep none)."""
        cfg = self.cfg
        sd = cfg.state_dtype
        plan = self.plan(params, metas)
        x_l = plan.flatten(params)
        per_worker = lambda p: torch.zeros((cfg.n_workers,) + tuple(p.shape),
                                           dtype=sd, device=p.device)
        return {
            "step": 0,
            "x": params,
            "g_server": plan.unflatten([torch.zeros(p.shape, dtype=sd,
                                                    device=p.device)
                                        for p in x_l]),
            "g_w": plan.unflatten([per_worker(p) for p in x_l]),
            "m_w": None if cfg.beta >= 1.0 else plan.unflatten(
                [per_worker(p) for p in x_l]),
            "cw_state": [lp.w2s.init(generator, lp.slice_shape,
                                     cfg.wire_dtype) for lp in plan.leaves],
        }

    # ------------------------------------------------------------ bookkeeping
    def wire_bytes_per_worker(self, params: Any, metas: Any) -> int:
        """Exact bytes of one worker's uint8 wire buffer — what the
        payload all-gather moves per worker."""
        return self.plan(params, metas).wire_layout(
            self.cfg.wire_dtype).total_nbytes

    def wire_budget(self, params: Any, metas: Any,
                    distributed: bool = True) -> WireBudget:
        """The :class:`WireBudget` of ``make_step``'s phase 4 on
        ``params``, through the same switches the step uses.
        ``distributed=False`` is the hook-less step (nothing packed)."""
        cfg = self.cfg
        plan = self.plan(params, metas)
        pack = bool(cfg.wire_pack and distributed)
        splan = resolve_stage_plan(cfg, plan, any_pack=pack)
        sizes: tuple[int, ...] = ()
        if pack and splan is not None:
            sw = plan.staged_wire_layout(cfg.wire_dtype, splan)
            sizes = tuple(sw.stage_nbytes(k) for k in range(sw.n_stages))
        elif pack:
            sizes = (plan.wire_layout(cfg.wire_dtype).total_nbytes,)
        return WireBudget(pack, False,
                          splan.n_stages if splan is not None else 1,
                          sizes, (), n_workers=cfg.n_workers)

    # ------------------------------------------------------------------ step
    def make_step(self, metas: Any,
                  reshard_payloads: Callable | None = None,
                  faults=None) -> Callable:
        """Returns ``step(state, grad_and_loss, batch, t) -> (state, aux)``;
        raises on what it does not run. ``reshard_payloads`` is the
        worker->server hook: it gets each ``[n_workers, nbytes]`` uint8
        wire (sub-)buffer (or, with ``wire_pack=False``, the list of
        per-leaf payloads) and returns what every worker received. None
        means single-process: nothing is packed."""
        cfg = self.cfg
        why = _unsupported(cfg, faults)
        if why is not None:
            raise NotImplementedError(f"repro_torch EF21Muon: {why}")
        pack_wire = cfg.wire_pack and reshard_payloads is not None

        def step(state: dict, grad_and_loss: Callable, batch: dict,
                 t) -> tuple[dict, dict]:
            plan = self.plan(state["x"], metas)
            buckets = plan.ns_buckets() if cfg.ns_bucketing else ()
            bucketed = {i for b in buckets for i in b.leaf_ids}
            x_flat = plan.flatten(state["x"])
            dev = x_flat[0].device
            t32 = torch.as_tensor(t, dtype=torch.float32, device=dev)

            # ---- 1. EF21-P with the identity s2w leg: W = X
            # ---- 2. per-worker stochastic gradients at W
            losses, grads_w = [], []
            for j in range(cfg.n_workers):
                loss, grads = grad_and_loss(
                    state["x"], {k: v[j] for k, v in batch.items()})
                losses.append(loss)
                grads_w.append(plan.flatten(grads))
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

                x_l[i] = _per_slice(one, lp.meta.stack_dims, x_flat[i],
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

            splan = resolve_stage_plan(cfg, plan, any_pack=pack_wire)
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
            aux = {"loss": torch.mean(torch.stack(losses)),
                   "grad_est_norm": torch.sqrt(sum(
                       torch.sum(torch.square(g.to(torch.float32)))
                       for g in gs_l))}
            return new_state, aux

        return step
