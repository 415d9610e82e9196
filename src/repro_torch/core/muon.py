"""EF21-Muon — the paper's contribution (Algorithms 1-3) in PyTorch.

Port of ``repro/core/muon.py`` on one process: full participation, the
identity server->worker leg (``s2w="identity"``, so the workers' model
estimate W is X itself) and no wire pack — the single-process reference
step skips the pack too (``muon.py:404-411``). Phases 2, 3 and 5 are
those of ``muon.py:615-659`` and ``804-841``:

    opt   = EF21Muon(cfg)
    state = opt.init(generator, params, metas)
    step  = opt.make_step(metas)
    state, aux = step(state, grad_and_loss, batch, t)

``grad_and_loss(params, batch_slice) -> (loss, grads)`` and every batch
entry has a leading worker dimension of size ``cfg.n_workers``; each
worker gets its own autograd pass. The worker dimension leads every
per-worker state tensor, as in the reference state. What the reference
has beyond this slice (metrics, elastic participation, resync, faults, a
compressing s2w leg) raises here instead of being ignored.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.dist.layerwise import LayerPlan, leaf_paths, tree_leaves

from .error_feedback import ef_compress_step
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
    ns_bucketing: bool = True      # batch spectral LMOs by shape bucket (§7)
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

    # ------------------------------------------------------------------ step
    def make_step(self, metas: Any, faults=None) -> Callable:
        """Returns ``step(state, grad_and_loss, batch, t) -> (state, aux)``
        for the single-process path; raises on what it does not run."""
        cfg = self.cfg
        why = _unsupported(cfg, faults)
        if why is not None:
            raise NotImplementedError(f"repro_torch EF21Muon: {why}")

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
                m_new = [((1.0 - beta) * m.to(torch.float32)
                          + beta * g.to(torch.float32)).to(m.dtype)
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

            # ---- 4. server receive: G += mean_j decompress(R_j)
            gs_l = []
            for lp, pl, gs in zip(plan.leaves, payloads,
                                  plan.flatten(state["g_server"])):
                d = lp.w2s.decompress(pl, (cfg.n_workers,) + lp.shape,
                                      torch.float32)
                gs_l.append((gs.to(torch.float32)
                             + torch.mean(d, dim=0)).to(gs.dtype))
            del payloads

            # ---- 5. layer-wise LMO on the server iterate; with
            # ns_bucketing the spectral leaves run one batched
            # Newton-Schulz chain per shape bucket (§7)
            def lmo_leaf(lp, x, g):
                d = lmo_direction(g, lp.meta.lmo, ns_steps=cfg.ns_steps)
                radius = t32 * lp.meta.radius_scale
                return (x.to(torch.float32)
                        + radius * d.to(torch.float32)).to(x.dtype)

            x_l = [x if i in bucketed else
                   _per_slice(partial(lmo_leaf, lp), lp.meta.stack_dims, x, g)
                   for i, (lp, x, g) in enumerate(zip(plan.leaves, x_flat,
                                                      gs_l))]
            for b in buckets:
                g_b = b.stack([gs_l[i] for i in b.leaf_ids])
                d_b = lmo_direction_batched(g_b, ns_steps=cfg.ns_steps)
                x_b = b.stack([x_flat[i] for i in b.leaf_ids],
                              dtype=torch.float32)
                x_b = x_b + (b.radius_vector(t32, dev)[:, None, None]
                             * d_b.to(torch.float32))
                for i, piece in zip(b.leaf_ids, b.unstack(x_b)):
                    x_l[i] = piece.to(x_flat[i].dtype)

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
