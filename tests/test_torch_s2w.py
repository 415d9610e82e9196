"""Parity of the port's EF21-P server->worker (s2w) leg with the
reference's, and of its Gluon and AdamW baselines.

The s2w leg: the server sends S = C_P(X - W) and every worker advances
its model estimate W by it, then differentiates at W. Its state (``w``,
``cs_state``) is integer-exact arithmetic on the same X and W, so after
one step from one carried-across state (``state_from_jax``) it must
equal the reference's bit for bit, and so must the EF21 state; x after
the Newton-Schulz LMO agrees within ``X_ATOL`` (``test_torch_optim.py``).
The gradient depends on the params (``Σ c·p + ½ Σ p²``, handed in as
``c + p`` on both sides, the same f32 sum), so a wrong W shows in it,
and the carried state has X ≠ W, so the step's message is not zero.

Beside that: the packed staged, packed monolithic and unpacked arms bit
for bit against each other; the layouts, issue order and wire budget
against the reference's, with nanogpt-124m's bytes pinned; the CLI
header; the trainer's broadcast hook over a one-rank gloo group; the
reduced-nanogpt trajectory; Gluon, AdamW and the recovery of Gluon by
EF21-Muon with identity compressors on one worker.
"""
from __future__ import annotations

import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core import compressors as jcomp
from repro.core import error_feedback as jef
from repro.core.adamw import adamw_init as jadamw_init
from repro.core.adamw import adamw_update as jadamw_update
from repro.core.gluon import gluon_init as jgluon_init
from repro.core.gluon import gluon_update as jgluon_update
from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.core.muon import ParamMeta as JParamMeta
from repro.core.schedule import warmup_linear_decay as jwarmup_linear_decay
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist.layerwise import LayerPlan as JLayerPlan
from repro.dist.layerwise import vmap_n
from repro.dist.pipeline import s2w_issue_order as js2w_issue_order
from repro.launch import train as jtrain_cli
from repro.models.api import abstract_params as jabstract_params
from repro.models.api import build_model as jbuild_model
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro.wire.layout import build_staged_layout as jbuild_staged_layout
from repro_torch.configs import get_config
from repro_torch.core import compressors as comp
from repro_torch.core import error_feedback as ef
from repro_torch.core.adamw import adamw_init, adamw_update
from repro_torch.core.gluon import gluon_init, gluon_update
from repro_torch.core.muon import EF21Muon, EF21MuonConfig, ParamMeta
from repro_torch.core.schedule import warmup_linear_decay
from repro_torch.dist.layerwise import LayerPlan, tree_leaves
from repro_torch.dist.pipeline import s2w_issue_order
from repro_torch.launch import train as train_cli
from repro_torch.models.api import (abstract_params, build_model,
                                    params_from_jax, state_from_jax)
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_threads import one_torch_thread  # noqa: F401

X_ATOL = 1e-6     # x after NS-driven LMO steps (see test_torch_optim.py)
S2W_NAMES = ["natural", "top10", "top10+natural"]
# the reduced trajectory's bounds (see test_torch_slice.py)
LOSS_ATOL_WARMUP = 1e-5
LOSS_ATOL = 1e-2


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tiny_tree():
    """test_torch_optim.py's tiny tree: a same-shape group, a transposed
    pair sharing a bucket, a stacked leaf and an incompressible vector."""
    rng = np.random.default_rng(0)
    shapes = {"wq": (48, 32), "wk": (48, 32), "w_in": (32, 80),
              "w_out": (80, 32), "blocks": (3, 48, 32), "bias": (32,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    metas = {"wq": ("spectral", 1.0, 0, True),
             "wk": ("spectral", 1.0, 0, True),
             "w_in": ("spectral", 1.5, 0, True),
             "w_out": ("spectral", 1.0, 0, True),
             "blocks": ("spectral", 2.0, 1, True),
             "bias": ("sign", 1.0, 0, False)}
    return params, metas


def _coeffs(params, seed, n_workers=2):
    """Per-worker linear coefficients c of the loss, the batch."""
    return {k: np.random.default_rng(seed + i).standard_normal(
        (n_workers,) + v.shape).astype(np.float32)
        for i, (k, v) in enumerate(params.items())}


def _grad_jax(params, c):
    # loss Σ c·p + ½ Σ p², its gradient c + p: one f32 add on both sides
    loss = sum(jnp.sum(c[k] * p) + 0.5 * jnp.sum(p * p)
               for k, p in params.items())
    return loss, {k: c[k] + p for k, p in params.items()}


def _grad_torch(params, c):
    loss = sum(torch.sum(c[k] * p) + 0.5 * torch.sum(p * p)
               for k, p in params.items())
    return loss, {k: c[k] + p for k, p in params.items()}


def _opts(s2w, **kw):
    params, metas = _tiny_tree()
    cfg = dict(n_workers=2, beta=0.5, w2s="top10", s2w=s2w, **kw)
    jmetas = {k: JParamMeta(*m) for k, m in metas.items()}
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    jopt = JEF21Muon(JEF21MuonConfig(use_pallas=False, **cfg))
    topt = EF21Muon(EF21MuonConfig(**cfg))
    return params, jopt, jmetas, topt, tmetas


def _jstep(jopt, jmetas, hook):
    step = jopt.make_step(jmetas, reshard_payloads=hook)
    return jax.jit(lambda st, c, t: step(st, _grad_jax, c, t))


def _tstep(topt, tmetas, hook):
    step = topt.make_step(tmetas, reshard_payloads=hook)
    return lambda st, c, t: step(st, _grad_torch, c, t)


def _jbatch(c):
    return {k: jnp.asarray(v) for k, v in c.items()}


def _tbatch(c):
    return {k: torch.from_numpy(v) for k, v in c.items()}


def _assert_bit_equal(tstate, jstate, keys):
    for key in keys:
        for k in jstate[key]:
            np.testing.assert_array_equal(tstate[key][k].numpy(),
                                          np.asarray(jstate[key][k]),
                                          err_msg=f"{key}/{k}")


def _assert_x_close(tstate, jstate, atol=X_ATOL):
    for k in jstate["x"]:
        np.testing.assert_allclose(tstate["x"][k].numpy(),
                                   np.asarray(jstate["x"][k]), rtol=0,
                                   atol=atol, err_msg=f"x/{k}")


def _assert_cs_equal(tstate, jstate, params):
    """The compressor states: per-leaf list on the port, a params-shaped
    tree in the reference (empty for Natural and TopK)."""
    want = state_from_jax(_np_tree(jstate))["cs_state"]
    assert len(tstate["cs_state"]) == len(want) == len(params)
    for got, w in zip(tstate["cs_state"], want):
        assert jax.tree.structure(got) == jax.tree.structure(w)


# ------------------------------------------------------- the EF21-P step

@pytest.mark.parametrize("s2w", S2W_NAMES)
@pytest.mark.parametrize("ns_bucketing", [True, False])
@pytest.mark.parametrize("packed", [False, True])
def test_s2w_step_from_carried_state_matches_reference(s2w, ns_bucketing,
                                                       packed):
    """One step from the reference's state after its first step (X ≠ W),
    carried across with ``state_from_jax``: w and cs_state, and g_w, m_w
    and g_server, bit-equal to the reference's; x within X_ATOL. Packed:
    both sides through their wire with an identity hook."""
    params, jopt, jmetas, topt, tmetas = _opts(
        s2w, ns_bucketing=ns_bucketing)
    hook = (lambda t: t) if packed else None
    jstep, tstep = _jstep(jopt, jmetas, hook), _tstep(topt, tmetas, hook)
    jstate = jopt.init(jax.random.key(0),
                       {k: jnp.asarray(v) for k, v in params.items()},
                       jmetas)
    jstate, _ = jstep(jstate, _jbatch(_coeffs(params, 100)),
                      jnp.float32(0.02))
    w_before = _np_tree(jstate["w"])
    assert any(np.any(np.asarray(jstate["x"][k]) != w_before[k])
               for k in params)                        # X ≠ W
    tstate = state_from_jax(_np_tree(jstate))
    c, t = _coeffs(params, 200), 0.04
    jstate, jaux = jstep(jstate, _jbatch(c), jnp.float32(t))
    tstate, taux = tstep(tstate, _tbatch(c), t)
    # the message was not zero: W moved
    assert any(np.any(tstate["w"][k].numpy() != w_before[k]) for k in params)
    assert tstate["step"] == int(jstate["step"]) == 2
    _assert_bit_equal(tstate, jstate, ("w", "g_w", "m_w", "g_server"))
    _assert_cs_equal(tstate, jstate, params)
    _assert_x_close(tstate, jstate)
    # the same bits summed in another order (f32 sums of ~2e4 terms)
    np.testing.assert_allclose(taux["loss"].item(), float(jaux["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(taux["grad_est_norm"].item(),
                               float(jaux["grad_est_norm"]), rtol=1e-5)


# W follows the NS-derived X: a difference of x below the bf16 rounding
# step of X - W leaves every bit of W equal; one that crosses a rounding
# boundary, a Natural power-of-two midpoint or a TopK tie moves that
# element of W by a whole wire quantum (a "flip", as ROADMAP Queue 3 item
# 2 counts TopK's). So W is held to X_ATOL element by element and its
# flips are counted; on these inputs there are none (measured: w, g_w,
# m_w and g_server bit-equal after 3 steps, x off by <= 4.8e-7 in ~5,800
# of 12,832 elements), and a flip would also break the bit-equal EF21
# state below.
W_FLIPS_ALLOWED = 0


@pytest.mark.parametrize("s2w", S2W_NAMES)
@pytest.mark.parametrize("ns_bucketing", [True, False])
def test_s2w_three_steps_from_init_track_reference(s2w, ns_bucketing):
    """Three packed steps from the same init with the W-dependent loss:
    w within X_ATOL with W_FLIPS_ALLOWED flips, the EF21 state bit-equal
    and x within X_ATOL, as in ``test_ef21_muon_step_matches_reference``."""
    params, jopt, jmetas, topt, tmetas = _opts(
        s2w, ns_bucketing=ns_bucketing)
    jstep = _jstep(jopt, jmetas, lambda t: t)
    tstep = _tstep(topt, tmetas, lambda t: t)
    jstate = jopt.init(jax.random.key(0),
                       {k: jnp.asarray(v) for k, v in params.items()},
                       jmetas)
    tstate = topt.init(None, {k: torch.from_numpy(v)
                              for k, v in params.items()}, tmetas)
    for s in range(3):
        c, t = _coeffs(params, 100 + 10 * s), 0.02 * (s + 1)
        jstate, jaux = jstep(jstate, _jbatch(c), jnp.float32(t))
        tstate, taux = tstep(tstate, _tbatch(c), t)
        np.testing.assert_allclose(taux["loss"].item(), float(jaux["loss"]),
                                   rtol=1e-5)
    flips = sum(int(np.sum(np.abs(tstate["w"][k].numpy()
                                  - np.asarray(jstate["w"][k])) > X_ATOL))
                for k in params)
    assert flips <= W_FLIPS_ALLOWED, f"{flips} elements of w flipped"
    for k in params:
        np.testing.assert_allclose(tstate["w"][k].numpy(),
                                   np.asarray(jstate["w"][k]), rtol=0,
                                   atol=X_ATOL, err_msg=f"w/{k}")
    _assert_bit_equal(tstate, jstate, ("g_w", "m_w", "g_server"))
    _assert_x_close(tstate, jstate)


def _run_port(s2w, hooks, steps=3, **kw):
    """The port's step on the tiny tree once per (hook, config) in
    ``hooks``, from one init on the same W-dependent loss."""
    params, metas = _tiny_tree()
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    states = []
    for hook, extra in hooks:
        opt = EF21Muon(EF21MuonConfig(n_workers=2, beta=0.5, w2s="top10",
                                      s2w=s2w, **kw, **extra))
        state = opt.init(None, {k: torch.from_numpy(v)
                                for k, v in params.items()}, tmetas)
        step = opt.make_step(tmetas, reshard_payloads=hook)
        for s in range(steps):
            state, _ = step(state, _grad_torch,
                            _tbatch(_coeffs(params, 100 + 10 * s)),
                            0.02 * (s + 1))
        states.append(state)
    return states


def _assert_states_equal(a, b):
    for key in ("x", "w", "g_server", "g_w", "m_w"):
        for u, v in zip(tree_leaves(a[key]), tree_leaves(b[key])):
            assert u.dtype == v.dtype and torch.equal(u, v), key
    assert a["cs_state"] == b["cs_state"] and a["step"] == b["step"]


@pytest.mark.parametrize("s2w", S2W_NAMES)
def test_s2w_arms_bit_equal(s2w):
    """With the reference's identity hook (``tests/test_pipeline.py``):
    the packed staged, packed monolithic (``wire_stages=1``) and unpacked
    (``wire_pack_s2w=False``) s2w arms, and the hook-less step, leave the
    same state bit for bit after 3 steps."""
    ident = lambda t: t     # noqa: E731
    base, staged, mono, unpacked = _run_port(s2w, [
        (None, {}), (ident, {}), (ident, dict(wire_stages=1)),
        (ident, dict(wire_pack_s2w=False))])
    for other in (staged, mono, unpacked):
        _assert_states_equal(other, base)


@pytest.mark.parametrize("s2w", S2W_NAMES)
@pytest.mark.parametrize("wire_stages", ["auto", 1])
def test_s2w_hook_gets_one_lead_1_buffer_per_stage(s2w, wire_stages):
    """The s2w hook (``reshard_updates``) gets a [1, nbytes] uint8 buffer
    per stage, in ``s2w_issue_order``, and the w2s hook its [2, nbytes]
    buffers; a copying hook leaves the state of the hook-less step."""
    seen = {"w2s": [], "s2w": []}

    def hook(direction):
        def fn(buf):
            assert buf.dtype == torch.uint8 and buf.ndim == 2
            seen[direction].append(tuple(buf.shape))
            return buf.clone()
        return fn

    params, metas = _tiny_tree()
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    opt = EF21Muon(EF21MuonConfig(n_workers=2, beta=0.5, w2s="top10",
                                  s2w=s2w, wire_stages=wire_stages))
    state = opt.init(None, {k: torch.from_numpy(v)
                            for k, v in params.items()}, tmetas)
    step = opt.make_step(tmetas, reshard_payloads=hook("w2s"),
                         reshard_updates=hook("s2w"))
    for s in range(2):
        state, _ = step(state, _grad_torch,
                        _tbatch(_coeffs(params, 100 + 10 * s)),
                        0.02 * (s + 1))
    (base,) = _run_port(s2w, [(None, dict(wire_stages=wire_stages))],
                        steps=2)
    _assert_states_equal(state, base)
    budget = opt.wire_budget(state["x"], tmetas)
    plan = opt.plan(state["x"], tmetas)
    if wire_stages == "auto":
        order = s2w_issue_order(plan, plan.stage_plan())
        assert len(order) == budget.n_stages == 3
    else:
        order = (0,)
    assert seen["s2w"] == [(1, budget.s2w_sizes[k]) for k in order] * 2
    assert seen["w2s"] == [(2, s) for s in budget.w2s_sizes] * 2


def test_ef_compress_is_the_sender_half_of_a_round():
    """``ef_compress`` gives ``ef_compress_step``'s payload and state,
    and the reference's payload; ``apply_payload`` of it gives the new
    estimate."""
    est, tgt = (np.random.default_rng(s).standard_normal((3, 48, 32))
                .astype(np.float32) for s in (1, 2))
    for name in S2W_NAMES + ["identity"]:
        c = comp.get_compressor(name)
        e, tg = torch.from_numpy(est), torch.from_numpy(tgt)
        pl, st = ef.ef_compress(c, {}, e, tg, (48, 32))
        pl2, st2, new = ef.ef_compress_step(c, {}, e, tg, (48, 32))
        jc = jcomp.get_compressor(name)
        jpl, _, jnew = vmap_n(lambda a, b: jef.ef_compress_step(
            jc, {}, a, b), 1)(jnp.asarray(est), jnp.asarray(tgt))
        for a, b, j in zip(jax.tree.leaves(pl), jax.tree.leaves(pl2),
                           jax.tree.leaves(jpl)):
            assert torch.equal(a, b)
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy() if a.dtype == torch.bfloat16
                else a.numpy(),
                np.asarray(j).view(np.int16) if a.dtype == torch.bfloat16
                else np.asarray(j))
        assert st == st2 == {}
        back = ef.apply_payload(c, pl, e)
        assert torch.equal(back, new)
        np.testing.assert_array_equal(back.numpy(), np.asarray(jnew))


def test_ef_compress_difference_is_contiguous_for_strided_operands():
    """After a bucketed step a leaf of x can be a transposed view (a
    transposed bucket member); the difference the wire's cast kernel
    reads is contiguous all the same, with the same values."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (32, 48)).astype(np.float32)).T.to(torch.bfloat16)
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (48, 32)).astype(np.float32))
    assert not x.is_contiguous()
    pl, _ = ef.ef_compress(comp.Identity(), {}, w, x, (48, 32))
    assert pl.is_contiguous()
    assert torch.equal(pl, x.float() - w)
    pl, _ = ef.ef_compress(comp.Natural(), {}, w, x, (48, 32))
    want, _ = ef.ef_compress(comp.Natural(), {}, w, x.contiguous(), (48, 32))
    assert all(torch.equal(pl[k], want[k]) for k in want)


# ------------------------------------- layouts, issue order, wire budget

def _plans(w2s, s2w, reduced=True):
    jcfg, cfg = jget_config("nanogpt-124m"), get_config("nanogpt-124m")
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jshapes, jmetas = jabstract_params(jbuild_model(jcfg))
    shapes, metas = abstract_params(build_model(cfg))
    return (JLayerPlan.build(jshapes, jmetas, w2s=w2s, s2w=s2w),
            LayerPlan.build(shapes, metas, w2s=w2s, s2w=s2w))


def _tiny_plans(s2w):
    params, metas = _tiny_tree()
    return (JLayerPlan.build({k: jnp.asarray(v) for k, v in params.items()},
                             {k: JParamMeta(*m) for k, m in metas.items()},
                             w2s="top10", s2w=s2w),
            LayerPlan.build({k: torch.from_numpy(v)
                             for k, v in params.items()},
                            {k: ParamMeta(*m) for k, m in metas.items()},
                            w2s="top10", s2w=s2w))


def _budget_fields(b):
    return (b.pack_w2s, b.pack_s2w, b.n_stages, b.w2s_sizes, b.s2w_sizes,
            b.n_workers, b.two_way_nbytes)


@pytest.mark.parametrize("s2w", S2W_NAMES + ["identity"])
@pytest.mark.parametrize("tree", ["tiny", "reduced", "full"])
def test_s2w_layout_and_issue_order_equal_reference(s2w, tree):
    """The s2w layout (monolithic and per stage), the issue order and the
    Table-2 s2w bytes equal the reference's; the w2s layout is unchanged
    beside it; incompressible leaves get identity both ways."""
    jplan, plan = (_tiny_plans(s2w) if tree == "tiny"
                   else _plans("top10", s2w, reduced=tree == "reduced"))
    assert [lp.s2w.name for lp in plan.leaves] == \
        [getattr(lp.s2w, "name", None) for lp in jplan.leaves]
    assert all(lp.s2w.name == "identity" for lp in plan.leaves
               if not lp.meta.compressible)
    for direction in ("w2s", "s2w"):
        layout = plan.wire_layout(torch.bfloat16, direction)
        assert layout.direction == direction
        assert layout.describe() == jplan.wire_layout(
            jnp.bfloat16, direction=direction).describe()
    sp, jsp = plan.stage_plan(), jplan.stage_plan()
    assert s2w_issue_order(plan, sp) == js2w_issue_order(jplan, jsp)
    sw = plan.staged_wire_layout(torch.bfloat16, sp, "s2w")
    jsw = jplan.staged_wire_layout(jnp.bfloat16, jsp, direction="s2w")
    assert [s.describe() for s in sw.stages] == \
        [s.describe() for s in jsw.stages]
    assert all(s.direction == "s2w" for s in sw.stages)
    assert plan.s2w_bytes_per_round(torch.bfloat16) == \
        jplan.s2w_bytes_per_round(jnp.bfloat16)


@pytest.mark.parametrize("s2w,stages,order,table2", [
    ("natural", (44_500_992, 63_700_992, 31_850_496), (1, 0, 2),
     139_975_680),
    ("top10", (23_726_908, 28_311_600, 14_155_920), (1, 0, 2), None)])
def test_full_nanogpt_s2w_bytes_pinned(s2w, stages, order, table2):
    """Full-width nanogpt-124m on meta tensors, ``--w2s top10+natural``,
    2 workers: the s2w stage buffers, their issue order, the Table-2 s2w
    bytes and the two-way wire, against the reference's and pinned."""
    shapes, metas = abstract_params(build_model(get_config("nanogpt-124m")))
    jshapes, jmetas = jabstract_params(jbuild_model(jget_config(
        "nanogpt-124m")))
    kw = dict(n_workers=2, w2s="top10+natural", s2w=s2w)
    opt = EF21Muon(EF21MuonConfig(**kw))
    b = opt.wire_budget(shapes, metas)
    jb = JEF21Muon(JEF21MuonConfig(**kw)).wire_budget(jshapes, jmetas)
    assert _budget_fields(b) == _budget_fields(jb)
    assert b.pack_s2w and b.s2w_sizes == stages
    assert b.w2s_sizes == (20_277_666, 23_357_088, 11_678_640)
    if s2w == "natural":
        assert b.two_way_nbytes == 195_365_874
    plan = opt.plan(shapes, metas)
    assert s2w_issue_order(plan, plan.stage_plan()) == order
    if table2 is not None:
        assert plan.s2w_bytes_per_round(torch.bfloat16) == table2


def test_reduced_nanogpt_s2w_bytes_pinned():
    """Reduced nanogpt, ``--w2s top10 --s2w natural``: the numbers the
    CLI header and the trainer's broadcasts show."""
    jplan, plan = _plans("top10", "natural")
    sp = plan.stage_plan()
    sw = plan.staged_wire_layout(torch.bfloat16, sp, "s2w")
    assert tuple(sw.stage_nbytes(k) for k in range(3)) == \
        (305_152, 589_824, 589_824)
    assert sw.total_nbytes == 1_484_800
    assert s2w_issue_order(plan, sp) == (1, 2, 0)
    assert plan.s2w_bytes_per_round(torch.bfloat16) == 1_479_680


@pytest.mark.parametrize("kw", [dict(), dict(wire_stages=1),
                                dict(wire_stages=2), dict(wire_pack=False),
                                dict(wire_pack_s2w=False),
                                dict(wire_pack=False, wire_pack_s2w=True),
                                dict(ns_bucketing=False),
                                dict(s2w="identity")])
@pytest.mark.parametrize("distributed", [True, False])
def test_two_way_wire_budget_equals_reference(kw, distributed):
    jshapes, jmetas = jabstract_params(jbuild_model(
        jget_config("nanogpt-124m").reduced()))
    shapes, metas = abstract_params(build_model(
        get_config("nanogpt-124m").reduced()))
    cfg = {"n_workers": 2, "w2s": "top10", "s2w": "natural", **kw}
    jb = JEF21Muon(JEF21MuonConfig(**cfg)).wire_budget(
        jshapes, jmetas, distributed=distributed)
    b = EF21Muon(EF21MuonConfig(**cfg)).wire_budget(
        shapes, metas, distributed=distributed)
    assert _budget_fields(b) == _budget_fields(jb)


def _s2w_payloads(jplan, seed):
    """Reference s2w payloads of random messages, per leaf with [1,
    *stack] leading dims (the server's one message)."""
    rng = np.random.default_rng(seed)
    out = []
    for lp in jplan.leaves:
        x = jnp.asarray(rng.standard_normal((1,) + lp.shape), jnp.float32)
        if not getattr(lp.s2w, "lossless_wire", False):
            x = x.astype(jnp.bfloat16)
        out.append(vmap_n(lambda s, c=lp.s2w: c.compress({}, s)[0],
                          lp.meta.stack_dims + 1)(x))
    return out


def _to_torch(pl):
    conv = lambda v: params_from_jax(np.asarray(v))   # noqa: E731
    return {k: conv(v) for k, v in pl.items()} if isinstance(pl, dict) \
        else conv(pl)


@pytest.mark.parametrize("s2w", S2W_NAMES)
def test_s2w_buffers_byte_equal_to_reference(s2w):
    """From the same lead-1 payloads, the port's monolithic and staged
    s2w buffers equal the reference's byte for byte, and unpack gives the
    payloads back bit for bit."""
    jplan, plan = _plans("top10", s2w)
    jpls = _s2w_payloads(jplan, 5)
    pls = [_to_torch(p) for p in jpls]
    jlayout = jplan.wire_layout(jnp.bfloat16, direction="s2w")
    layout = plan.wire_layout(torch.bfloat16, "s2w")
    buf = layout.pack(pls)
    assert buf.shape == (1, layout.total_nbytes)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jlayout.pack(jpls)))
    jsw = jbuild_staged_layout(
        jlayout, [s.leaf_ids for s in jplan.stage_plan().stages])
    sw = plan.staged_wire_layout(torch.bfloat16, plan.stage_plan(), "s2w")
    for k in range(sw.n_stages):
        sbuf = sw.pack_stage(k, pls)
        np.testing.assert_array_equal(sbuf.numpy(),
                                      np.asarray(jsw.pack_stage(k, jpls)))
        for i, got in zip(sw.stage_leaf_ids[k], sw.unpack_stage(k, sbuf)):
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(pls[i])):
                assert a.dtype == b.dtype and torch.equal(a, b)


# ----------------------------------------------------- trainer and CLI

SEQ, BATCH, WORKERS, STEPS = 32, 4, 2, 10
# The two-way curves meet the one-way bounds one step earlier: the
# warm-up bound holds for steps 0-2, not 0-3. The port's and the
# reference's gradients differ in summation order, TopK flips ties on
# them (ROADMAP Queue 3 item 2), and x drifts by ~1e-6 by step 1. One way,
# that moves the loss by < 1e-6 until step 3. Two ways, W is X quantised
# by Natural: where X - W crosses a power-of-two midpoint, such a drift
# moves that element of W by a whole quantum (measured: 958 of 1,313,280
# elements of W at step 2, up to 2.4e-4), and the loss at W separates at
# step 3 (4.5e-5). Measured over all 10 steps: at most 5.0e-3.
WARMUP_STEPS_TWO_WAY = 3


@pytest.mark.parametrize("s2w", ["natural", "top10"])
def test_cli_header_two_way_equals_reference(s2w, capsys, monkeypatch):
    """Field for field, ``device=`` aside: ``s2w_bytes/round``,
    ``s2w_wire_buffer`` and ``two_way_wire`` included."""
    argv = ["--arch", "nanogpt-124m", "--reduced", "--steps", "0", "--seq",
            "16", "--batch", "2", "--workers", "2", "--w2s", "top10",
            "--s2w", s2w]
    train_cli.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()[0].split()
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain_cli.main()
    theirs = capsys.readouterr().out.splitlines()[0].split()
    assert ours[-1] == "device=cpu"
    assert ours[:-1] == theirs
    if s2w == "natural":
        assert {"s2w_bytes/round=1479680", "s2w_wire_buffer=1484800",
                "two_way_wire=2098008"} <= set(ours)


def test_cli_runs_the_two_way_step_unpacked(capsys):
    out = train_cli.main(["--arch", "nanogpt-124m", "--reduced", "--steps",
                          "2", "--seq", "16", "--batch", "2", "--workers",
                          "2", "--s2w", "natural", "--log-every", "1",
                          "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(map(math.isfinite,
                                               out["losses"]))
    lines = capsys.readouterr().out.strip().splitlines()
    # the header, a loss line a step, the reference's summary line last
    assert lines[0].startswith("arch=nanogpt-124m ")
    assert [json.loads(x)["step"] for x in lines
            if x.startswith('{"step"')] == [0, 1]
    assert lines[-1].startswith("RESYNC_SUMMARY ")


@pytest.fixture(scope="module")
def gloo_group():
    from torch.distributed import HashStore
    dist.init_process_group("gloo", store=HashStore(), rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("wire_stages", ["auto", 1])
def test_trainer_broadcasts_over_one_rank_gloo_group(gloo_group,
                                                     wire_stages):
    """Reduced nanogpt, ``--w2s top10 --s2w natural``, 2 steps: each
    step broadcasts the s2w budget's stage buffers in issue order and
    all-gathers the w2s budget's, as the one-way trainer does; the losses
    equal the group-less (unpacked) trainer's."""
    args = train_cli.parse_args(["--arch", "nanogpt-124m", "--reduced",
                                 "--seq", "16", "--batch", "2", "--workers",
                                 "2", "--s2w", "natural", "--device", "cpu"])
    cfg, _, data, sched = train_cli.setup(args)
    runs = []
    for group, s2w in ((None, "natural"), (gloo_group, "natural"),
                       (gloo_group, "identity")):
        tr = Trainer(build_model(cfg), TrainerConfig(
            n_workers=2, beta=args.beta, w2s="top10", s2w=s2w,
            wire_stages=wire_stages), device="cpu", group=group)
        out = train_cli.run_steps(tr, tr.init(0), data, sched, 2)
        runs.append((tr, out["losses"]))
    (tr0, l0), (tr, l1), (tr_oneway, _) = runs
    assert l1 == l0 and tr0.gathered == tr0.broadcast_bytes == []
    budget = tr.wire_budget()
    plan = tr.layer_plan()
    order = (s2w_issue_order(plan, plan.stage_plan())
             if wire_stages == "auto" else (0,))
    assert budget.pack_s2w and len(budget.s2w_sizes) == len(order)
    assert tr.broadcast_bytes == [budget.s2w_sizes[k] for k in order] * 2
    if wire_stages == "auto":
        assert tr.broadcast_bytes == [589_824, 589_824, 305_152] * 2
    assert sum(tr.broadcast_bytes) == 2 * 1_484_800
    assert tr.gathered == tr_oneway.gathered \
        == [2 * s for s in budget.w2s_sizes] * 2
    assert tr_oneway.broadcast_bytes == []


def test_trainer_unpacked_s2w_arm_broadcasts_nothing(gloo_group):
    """``TrainerConfig.wire_pack_s2w=False`` over a group: the w2s wire
    stays packed, the EF21-P leg runs unpacked (no broadcast, an empty
    ``s2w_sizes``), and the losses equal the packed arm's."""
    args = train_cli.parse_args(["--arch", "nanogpt-124m", "--reduced",
                                 "--seq", "16", "--batch", "2", "--workers",
                                 "2", "--s2w", "natural", "--device", "cpu"])
    cfg, _, data, sched = train_cli.setup(args)
    runs = []
    for pack_s2w in ("auto", False):
        tr = Trainer(build_model(cfg), TrainerConfig(
            n_workers=2, beta=args.beta, w2s="top10", s2w="natural",
            wire_pack_s2w=pack_s2w), device="cpu", group=gloo_group)
        out = train_cli.run_steps(tr, tr.init(0), data, sched, 2)
        runs.append((tr, out["losses"]))
    (packed, l0), (unpacked, l1) = runs
    assert l1 == l0 and unpacked.gathered == packed.gathered
    assert unpacked.broadcast_bytes == [] and len(packed.broadcast_bytes) == 6
    budget = unpacked.wire_budget()
    assert budget.pack_w2s and not budget.pack_s2w and budget.s2w_sizes == ()


def test_broadcast_hook_refuses_what_is_not_an_s2w_buffer(gloo_group):
    tr = Trainer(build_model(get_config("nanogpt-124m").reduced()),
                 TrainerConfig(s2w="natural"), device="cpu",
                 group=gloo_group)
    for bad in (torch.zeros((2, 8), dtype=torch.uint8),
                torch.zeros((1, 8), dtype=torch.int32),
                torch.zeros(8, dtype=torch.uint8)):
        with pytest.raises(ValueError, match="s2w broadcast"):
            tr._broadcast(bad)
    assert tr.broadcast_bytes == []


def test_step_profile_needs_a_card(monkeypatch):
    """``python -m repro_torch.launch.profile_step`` (the one-way and
    two-way steps under ``torch.profiler``) exits without a card, before
    it builds or runs anything."""
    from repro_torch.launch import profile_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        profile_step.main([])
    assert profile_step.TWO_WAY[profile_step.TWO_WAY.index("--s2w") + 1] \
        == "natural"


def test_trainer_two_way_tracks_reference_over_10_steps():
    """The slice as a whole with the EF21-P leg: reduced nanogpt, 2
    workers, ``--w2s top10 --s2w natural``, beta 0.5, from the reference's
    initial params on its batches; the loss curve within the one-way
    trajectory's bounds (``test_torch_slice.py``; the warm-up one for
    ``WARMUP_STEPS_TWO_WAY``) and descending."""
    jcfg = jget_config("nanogpt-124m").reduced()
    jmodel = jbuild_model(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    data = JSyntheticLM(jcfg, JShapeSpec("t", "train", SEQ, BATCH),
                        n_workers=WORKERS, seed=0)
    kw = dict(n_workers=WORKERS, beta=0.5, w2s="top10", s2w="natural")
    jtr = JTrainer(jmodel, JTrainerConfig(remat=False, use_pallas=False,
                                          **kw))
    jstate = jtr.opt.init(jax.random.key(1), jparams, jtr.metas)
    jstep = jtr.jit_step(None)
    tr = Trainer(build_model(get_config("nanogpt-124m").reduced()),
                 TrainerConfig(**kw), device="cpu")
    state = tr.opt.init(None, params_from_jax(_np_tree(jparams)), tr.metas)
    step = tr.make_step()
    jsched = jwarmup_linear_decay(0.01, 3, STEPS)
    sched = warmup_linear_decay(0.01, 3, STEPS)
    jl, tl = [], []
    for i in range(STEPS):
        jb = data.batch_at(i)
        jstate, jaux = jstep(jstate, jb, jsched(i))
        state, aux = step(state, {k: torch.from_numpy(np.array(v)).to(
            torch.int64) for k, v in jb.items()}, sched(i))
        jl.append(float(jaux["loss"]))
        tl.append(float(aux["loss"]))
    n = WARMUP_STEPS_TWO_WAY
    np.testing.assert_allclose(tl[:n], jl[:n], rtol=0,
                               atol=LOSS_ATOL_WARMUP)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_ATOL)
    assert tl[-1] < tl[0] - 0.1
    assert set(state) == set(jstate)


# --------------------------------------------------- state carried across

def test_state_from_jax_carries_every_key():
    params, jopt, jmetas, topt, tmetas = _opts("natural")
    jstate = jopt.init(jax.random.key(0),
                       {k: jnp.asarray(v) for k, v in params.items()},
                       jmetas)
    tstate = state_from_jax(_np_tree(jstate))
    fresh = topt.init(None, {k: torch.from_numpy(v)
                             for k, v in params.items()}, tmetas)
    assert set(tstate) == set(fresh) == set(jstate)
    assert tstate["step"] == 0
    for key in ("x", "w", "g_server", "g_w", "m_w"):
        for a, b in zip(tree_leaves(tstate[key]), tree_leaves(fresh[key])):
            assert a.dtype == b.dtype and torch.equal(a, b), key
    assert tstate["cs_state"] == fresh["cs_state"] == [{}] * len(params)
    # the resync state is carried since the rejoin slice; a key that is
    # no part of an EF21-Muon state still raises
    with pytest.raises(ValueError, match="no part of an EF21-Muon state"):
        state_from_jax({**_np_tree(jstate), "bogus": {}})


# ----------------------------------------------- Gluon, AdamW, recovery

@pytest.mark.parametrize("steps", [1, 3])
def test_gluon_matches_reference(steps):
    """Gluon on the tiny tree from handed-in gradients: the moments
    bit-equal, x within X_ATOL (NS-derived)."""
    params, metas = _tiny_tree()
    jmetas = {k: JParamMeta(*m) for k, m in metas.items()}
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jgluon_init(jp), gluon_init(tp)
    for s in range(steps):
        g = {k: v[0] for k, v in _coeffs(params, 300 + 10 * s).items()}
        t = 0.02 * (s + 1)
        jp, js = jgluon_update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                               js, jmetas, t, beta=0.3, use_pallas=False)
        tp, ts = gluon_update(tp, _tbatch(g), ts, tmetas, t, beta=0.3)
    assert ts["step"] == int(js["step"]) == steps
    for k in params:
        np.testing.assert_array_equal(ts["m"][k].numpy(),
                                      np.asarray(js["m"][k]), err_msg=k)
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=X_ATOL, err_msg=k)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_reference(weight_decay):
    """AdamW on the tiny tree, 3 steps: the moments bit-equal (the same
    f32 arithmetic); the params within 1e-6 relative, since the bias
    corrections ``1 - b ** t`` and the update's division are f32 power
    and division that XLA and PyTorch may round apart (measured: 3-5 of
    12,832 elements one f32 ulp apart)."""
    params, _ = _tiny_tree()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jadamw_init(jp), adamw_init(tp)
    for s in range(3):
        g = {k: v[0] for k, v in _coeffs(params, 400 + 10 * s).items()}
        jp, js = jadamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                               js, 1e-2, weight_decay=weight_decay)
        tp, ts = adamw_update(tp, _tbatch(g), ts, 1e-2,
                              weight_decay=weight_decay)
    assert ts["step"] == int(js["step"]) == 3
    for k in params:
        for key in ("mu", "nu"):
            np.testing.assert_array_equal(ts[key][k].numpy(),
                                          np.asarray(js[key][k]), err_msg=k)
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_identity_single_worker_recovers_gluon():
    """The paper's recovery property on the port (the reference's
    ``tests/test_muon_recovery.py``): EF21-Muon with identity compressors
    both ways on one worker walks Gluon's iterates, within the
    reference's own tolerance (its EF21 estimate is G + (M - G) in f32,
    not M itself)."""
    rng = np.random.default_rng(7)
    target = {"w": rng.standard_normal((12, 8)).astype(np.float32),
              "v": rng.standard_normal(16).astype(np.float32)}
    metas = {"w": ParamMeta("spectral", 1.0, 0), "v": ParamMeta("sign", 1.0,
                                                                  0)}
    params = {k: torch.zeros(v.shape) for k, v in target.items()}
    tgt = {k: torch.from_numpy(v) for k, v in target.items()}

    def grad_and_loss(p, batch):
        return (sum(0.5 * torch.sum((p[k] - tgt[k]) ** 2) for k in p),
                {k: p[k] - tgt[k] for k in p})

    opt = EF21Muon(EF21MuonConfig(n_workers=1, beta=0.3, w2s="identity",
                                  s2w="identity"))
    state = opt.init(None, params, metas)
    step = opt.make_step(metas)
    gp, gstate = params, gluon_init(params)
    for _ in range(6):
        state, _ = step(state, grad_and_loss, {"b": torch.zeros(1, 1)}, 0.05)
        _, grads = grad_and_loss(gp, None)
        gp, gstate = gluon_update(gp, grads, gstate, metas, 0.05, beta=0.3)
        for k in ("w", "v"):
            np.testing.assert_allclose(state["x"][k].numpy(), gp[k].numpy(),
                                       rtol=1e-5, atol=1e-6)
