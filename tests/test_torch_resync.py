"""Parity of the port's desynchronized-worker rejoin (``resync``,
DESIGN.md §13) with the reference's.

The algebra of ``repro_torch.dist.resync`` against ``repro.dist.resync``
bit for bit: the ring depth, the fresh state and its oversized-row
error, the ring push, the replay masks on random version vectors (lag 0,
the ring's last replayable lag R-1, lag R and R+1, every worker absent).

From one state carried across (``state_from_jax``) at each rejoin step
of a schedule (a worker replaying the rounds it missed, a worker gone
too long taking the full W copy, a step with every worker absent), one
port step against one reference step, in the unpacked, staged packed and
monolithic packed arms: on the heterogeneous quadratic of
``tests/test_resync.py`` (worker j pulls toward its own target; here on
``test_torch_s2w.py``'s tiny tree, so the packed arm has three stages),
the version vector, the ring's bytes, W_j, W, the EF21 state and the
counts bit for bit and x within ``X_ATOL``; on reduced nanogpt two-way
Natural, everything the rejoin computes (it runs before the gradients)
bit for bit, and the rest within the bounds of a step whose gradients
differ in summation order (ROADMAP Queue 3 item 2).

Then the port's own invariants (``tests/test_resync.py``'s), the CLI
against the reference's, and the NaN bits of the rejoin's f32 add and of
the server's fold, which ``chip_smoke.py`` holds the card to.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.core.muon import ParamMeta as JParamMeta
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist import participation as jpart
from repro.dist import resync as jresync
from repro.launch import train as jtrain_cli
from repro.models.api import build_model as jbuild_model
from repro.train import faults as jfaults
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config
from repro_torch.core import compressors as comp
from repro_torch.core.muon import EF21Muon, EF21MuonConfig, ParamMeta
from repro_torch.dist import resync
from repro_torch.dist.layerwise import tree_leaves
from repro_torch.dist.participation import Explicit
from repro_torch.launch import train as train_cli
from repro_torch.models.api import (build_model, params_from_jax,
                                    state_from_jax, state_to_numpy)
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_obs import METRIC_RTOL
from test_torch_s2w import (X_ATOL, _coeffs, _grad_jax, _grad_torch,
                            _np_tree, _tiny_tree)
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


# --------------------------------------------------------- the algebra

@pytest.mark.parametrize("value", [None, 0, False, True, 1, 4])
def test_resolve_ring_depth_equals_reference(value):
    assert resync.resolve_ring_depth(value) \
        == jresync.resolve_ring_depth(value)


@pytest.mark.parametrize("value", [-1, -3])
def test_resolve_ring_depth_rejects_negative_like_reference(value):
    with pytest.raises(ValueError) as want:
        jresync.resolve_ring_depth(value)
    with pytest.raises(ValueError) as got:
        resync.resolve_ring_depth(value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,r,row", [(1, 1, 1), (2, 4, 97), (5, 3, 64)])
def test_init_resync_state_equals_reference(n, r, row):
    want = jresync.init_resync_state(n, r, row)
    got = resync.init_resync_state(n, r, row)
    assert got["vv"].dtype == torch.int32 and got["ring"].dtype == torch.uint8
    for key in ("vv", "ring"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        assert got[key].numpy().dtype == np.asarray(want[key]).dtype


def test_init_resync_state_rejects_oversized_row_like_reference():
    with pytest.raises(ValueError) as want:
        jresync.init_resync_state(4, 3, 2**31)
    with pytest.raises(ValueError) as got:
        resync.init_resync_state(4, 3, 2**31)
    assert str(got.value) == str(want.value)
    assert "serve_full_resync" in str(got.value)


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("inplace", [False, True])
def test_ring_push_equals_reference(r, inplace):
    """The new row, given whole or as stage parts, lands in slot R-1 and
    the rest move one slot forward; in place, in the ring's own tensor
    (no copy overlaps its source), otherwise in a new one."""
    rng = np.random.default_rng(r)
    ring = rng.integers(0, 256, (r, 37), dtype=np.uint8)
    row = rng.integers(0, 256, 37, dtype=np.uint8)
    want = np.asarray(jresync.ring_push(jnp.asarray(ring), jnp.asarray(row)))
    t = torch.from_numpy(ring.copy())
    got = resync.ring_push(t, torch.from_numpy(row[:10]),
                           torch.from_numpy(row[10:]), inplace=inplace)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got is t) == inplace
    if not inplace:
        np.testing.assert_array_equal(t.numpy(), ring)
    with pytest.raises(ValueError, match="ring row"):
        resync.ring_push(t, torch.from_numpy(row[:10]))


def _assert_masks_equal(got, want):
    for f in ("apply", "full", "vv_new", "n_replayed", "n_full", "lag_max"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("seed", range(3))
def test_replay_masks_random_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n, r = int(rng.integers(1, 6)), int(rng.integers(1, 6))
        step = int(rng.integers(0, 20))
        vv = rng.integers(max(0, step - 2 * r), step + 1, n).astype(np.int32)
        recv = rng.random(n) < 0.6
        _assert_masks_equal(
            resync.replay_masks(torch.from_numpy(vv), step,
                                torch.from_numpy(recv), r),
            jresync.replay_masks(jnp.asarray(vv), step, jnp.asarray(recv), r))


@pytest.mark.parametrize("missed,present", [
    (0, True), (3, True), (4, True), (5, True), (2, False)])
def test_replay_masks_edges_equal_reference(missed, present):
    """Worker 1 missed ``missed`` rounds, R = 4: it replays up to R-1 of
    them (the ring also holds the current round) and takes the full copy
    from R on; with nobody present, nobody moves."""
    r, step = 4, 9
    vv = np.array([step, step - missed, step], np.int32)
    recv = np.full(3, present)
    got = resync.replay_masks(torch.from_numpy(vv), step,
                              torch.from_numpy(recv), r)
    _assert_masks_equal(got, jresync.replay_masks(
        jnp.asarray(vv), step, jnp.asarray(recv), r))
    full = present and missed >= r
    assert bool(got.full[1]) == full
    assert int(got.apply[:, 1].sum()) == (0 if full or not present
                                         else missed + 1)
    assert int(got.lag_max) == (0 if present else missed + 1)


# ------------------------------------------- one step from a carried state

R = 2
# worker 1 misses round 1 (replays R-1 = 1 at step 2), then rounds 3-4 (2 =
# R: the full copy at step 5); at step 6 nobody is there
TABLE = ((1, 1, 1, 1), (1, 0, 1, 1), (1, 1, 1, 1), (1, 0, 1, 1),
         (1, 0, 1, 1), (1, 1, 1, 1), (0, 0, 0, 0))
CASES = {2: (1, 0), 5: (0, 1), 6: (0, 0)}     # step: (replayed, full)
# reduced nanogpt, shorter: nobody hears round 2; at step 3 worker 0
# replays it and worker 1, R = 2 rounds behind, takes the full copy
NANO_TABLE = ((1, 1), (1, 0), (0, 0), (1, 1))
NANO_CASES = {2: (0, 0), 3: (1, 1)}
ARMS = {"unpacked": (False, {}), "staged": (True, {}),
        "monolithic": (True, {"wire_stages": 1})}


def _assert_tree_bits(got, want, what):
    """A port tree (or tensor) against the reference's, bit for bit."""
    want = _np_tree(want)
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_tree_bits(got[k], want[k], f"{what}/{k}")
        return
    g = got.view(torch.int16).numpy() if got.dtype == torch.bfloat16 \
        else got.numpy()
    w = np.asarray(want)
    w = w.view(np.int16) if w.dtype.itemsize == 2 and g.dtype == np.int16 \
        else w
    assert g.shape == w.shape, what
    np.testing.assert_array_equal(g, w, err_msg=what)


def _assert_rejoin_equal(tstate, taux, jstate, jaux, counts, table):
    """What the rejoin computes, bit for bit: the version vector, the
    ring's bytes, W_j, W and the counts, ``counts`` (replayed, full)."""
    _assert_tree_bits(tstate["resync"], jstate["resync"], "resync")
    _assert_tree_bits(tstate["w_w"], jstate["w_w"], "w_w")
    _assert_tree_bits(tstate["w"], jstate["w"], "w")
    for key in ("resync_replayed", "resync_full", "version_lag_max",
                "n_participants"):
        assert int(taux[key]) == int(jaux[key]), key
    assert taux["resync_replayed"].dtype == torch.int32
    assert (int(taux["resync_replayed"]), int(taux["resync_full"])) == counts
    row = table[int(tstate["step"]) - 1]
    if not any(row):
        assert int(taux["n_participants"]) == 0 and bool(taux["skipped"])
    # the workers present are current: W_j is the server's W, bit for bit
    for w, ww in zip(tree_leaves(tstate["w"]), tree_leaves(tstate["w_w"])):
        for j in range(ww.shape[0]):
            if row[j]:
                assert torch.equal(ww[j], w), j
    assert int(tstate["resync"]["ring"].count_nonzero()) > 0


def _quadratic(n_workers=4):
    params, metas = _tiny_tree()
    jmetas = {k: JParamMeta(*m) for k, m in metas.items()}
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    c = _coeffs(params, 100, n_workers)
    return params, jmetas, tmetas, c


def _cfg(n_workers, **kw):
    return dict(n_workers=n_workers, beta=0.5, w2s="top10", s2w="natural",
                resync=R, **kw)


@pytest.mark.parametrize("arm", list(ARMS))
def test_rejoin_from_carried_state_on_the_quadratic(arm):
    """At steps 2 (a replay), 5 (a full copy) and 6 (nobody present): one
    port step from the reference's state, every key of the state bit for
    bit but x (within X_ATOL), against the ring of the same arm."""
    packed, kw = ARMS[arm]
    params, jmetas, tmetas, c = _quadratic()
    hook = (lambda t: t) if packed else None
    jopt = JEF21Muon(JEF21MuonConfig(use_pallas=False, **_cfg(
        4, participation=jpart.Explicit(TABLE), **kw)))
    topt = EF21Muon(EF21MuonConfig(**_cfg(4, participation=Explicit(TABLE),
                                          **kw)))
    if packed:
        assert topt.wire_budget({k: torch.from_numpy(v) for k, v in
                                 params.items()}, tmetas).n_stages \
            == (1 if kw else 3)
    jfn = jopt.make_step(jmetas, reshard_payloads=hook)
    jstep = jax.jit(lambda s, b, t: jfn(s, _grad_jax, b, t))
    tstep = topt.make_step(tmetas, reshard_payloads=hook)
    jb = {k: jnp.asarray(v) for k, v in c.items()}
    tb = {k: torch.from_numpy(v) for k, v in c.items()}
    jstate = jopt.init(jax.random.key(0),
                       {k: jnp.asarray(v) for k, v in params.items()},
                       jmetas)
    for s in range(max(CASES) + 1):
        t = 0.01 + 0.005 * s
        tstate = state_from_jax(_np_tree(jstate)) if s in CASES else None
        jstate, jaux = jstep(jstate, jb, jnp.float32(t))
        if tstate is None:
            continue
        tstate, taux = tstep(tstate, _grad_torch, tb, t)
        _assert_rejoin_equal(tstate, taux, jstate, jaux, CASES[s], TABLE)
        for key in ("g_w", "m_w", "g_server"):
            _assert_tree_bits(tstate[key], jstate[key], key)
        for k in params:
            np.testing.assert_allclose(tstate["x"][k].numpy(),
                                       np.asarray(jstate["x"][k]), rtol=0,
                                       atol=X_ATOL, err_msg=f"x/{k}")


SEQ, BATCH = 32, 4


@pytest.mark.parametrize("arm", list(ARMS))
def test_rejoin_from_carried_state_on_reduced_nanogpt(arm):
    """Reduced nanogpt, 2 workers, ``--w2s top10 --s2w natural``: the
    rejoin bit for bit at the step nobody is present and at the next,
    where one worker replays and the other takes the full copy; the loss within 1e-5, the momentum within 1e-5 of its largest
    entry and the EF21 state and x within 1e-2 of their norms (the
    gradients differ in summation order, which can flip a TopK tie)."""
    packed, kw = ARMS[arm]
    table = NANO_TABLE
    jcfg = jget_config("nanogpt-124m").reduced()
    jmodel = jbuild_model(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    data = JSyntheticLM(jcfg, JShapeSpec("t", "train", SEQ, BATCH),
                        n_workers=2, seed=0)
    tcfg = dict(_cfg(2), **kw)
    jtr = JTrainer(jmodel, JTrainerConfig(
        remat=False, use_pallas=False,
        participation=jpart.Explicit(table), **tcfg))
    tr = Trainer(build_model(get_config("nanogpt-124m").reduced()),
                 TrainerConfig(participation=Explicit(table), **tcfg),
                 device="cpu")
    hook = (lambda t: t) if packed else None
    jfn = jtr.opt.make_step(jtr.metas, reshard_payloads=hook)
    jstep = jax.jit(lambda s, b, t: jfn(s, jtr._grad_and_loss, b, t))
    tfn = tr.opt.make_step(tr.metas, reshard_payloads=hook)
    jstate = jtr.opt.init(jax.random.key(1), jparams, jtr.metas)
    for s in range(max(NANO_CASES) + 1):
        t = 0.01 * min(1.0, (s + 1) / 3)
        jb = data.batch_at(s)
        carried = s in NANO_CASES
        tstate = state_from_jax(_np_tree(jstate)) if carried else None
        x_before = _np_tree(jstate["x"]) if carried else None
        jstate, jaux = jstep(jstate, jb, jnp.float32(t))
        if tstate is None:
            continue
        tstate, taux = tfn(tstate, tr._grad_and_loss, {
            k: torch.from_numpy(np.array(v)).to(torch.int64)
            for k, v in jb.items()}, t)
        _assert_rejoin_equal(tstate, taux, jstate, jaux, NANO_CASES[s],
                             table)
        np.testing.assert_allclose(taux["loss"].item(), float(jaux["loss"]),
                                   rtol=0, atol=1e-5)
        js = _np_tree(jstate)
        ts = state_to_numpy(tstate)
        for key in ("m_w", "g_w", "g_server", "x"):
            want = dict(jax.tree_util.tree_flatten_with_path(js[key])[0])
            before = dict(jax.tree_util.tree_flatten_with_path(
                x_before)[0]) if key == "x" else None
            for path, a in jax.tree_util.tree_flatten_with_path(
                    ts[key])[0]:
                a, b = _as_f32(a), _as_f32(want[path])
                what = f"{key}{jax.tree_util.keystr(path)}"
                if key == "m_w":
                    np.testing.assert_allclose(
                        a, b, rtol=0, atol=1e-5 * np.abs(b).max(),
                        err_msg=what)
                elif key == "x":
                    moved = np.linalg.norm(b - _as_f32(before[path]))
                    assert np.linalg.norm(a - b) <= 1e-2 * moved + 1e-7, what
                else:
                    assert np.linalg.norm(a - b) \
                        <= 1e-2 * np.linalg.norm(b) + 1e-12, what


def _as_f32(a):
    """An array as f32 (bf16 from its 2-byte patterns or ml_dtypes)."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind != "f":
        a = (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


# ------------------------------------------------ the port's invariants

ABSENT, K = 1, 3     # worker 1 misses K consecutive broadcasts


def _absence(start=3, k=K, n_w=4):
    full = (1,) * n_w
    gone = tuple(0 if j == ABSENT else 1 for j in range(n_w))
    return (full,) * start + (gone,) * k + (full,) * 8


def _run(steps, hook=None, donate=False, masks=None, n_w=4, **kw):
    """The port's step on the tiny quadratic: (state, auxes)."""
    params, _, tmetas, c = _quadratic(n_w)
    cfg = dict(dict(n_workers=n_w, beta=0.5, w2s="top10", s2w="natural"),
               **kw)
    if masks is not None:
        cfg["participation"] = Explicit(tuple(masks))
    opt = EF21Muon(EF21MuonConfig(**cfg))
    state = opt.init(None, {k: torch.from_numpy(v.copy())
                            for k, v in params.items()}, tmetas)
    step = opt.make_step(tmetas, reshard_payloads=hook, donate=donate)
    tb = {k: torch.from_numpy(v) for k, v in c.items()}
    auxes = []
    for s in range(steps):
        state, aux = step(state, _grad_torch, tb, 0.01 + 0.005 * s)
        auxes.append(aux)
    return state, auxes


def _assert_all_current(state):
    for w, ww in zip(tree_leaves(state["w"]), tree_leaves(state["w_w"])):
        for j in range(ww.shape[0]):
            assert torch.equal(ww[j], w), j


def _identity_wire():
    comp.REGISTRY.setdefault(
        "identity-wire", lambda: type("IdentityWire", (comp.Identity,), {})())
    return "identity-wire"


@pytest.mark.parametrize("s2w", ["natural", "top10", "identity-wire"])
def test_rejoin_within_ring_is_bit_identical(s2w):
    """Lag K = 3 <= R - 1 with R = 4: a replay, after which every W_j is
    the server's W bit for bit, lossy or lossless; the lag grows to K
    during the absence and is 0 at the end. On the lossless wire W
    trails X by at most one LMO step (radius t, spectral: t sqrt(dim))."""
    if s2w == "identity-wire":
        _identity_wire()
    state, auxes = _run(steps=8, masks=_absence(), resync=4, s2w=s2w)
    assert sum(int(a["resync_replayed"]) for a in auxes) == 1
    assert sum(int(a["resync_full"]) for a in auxes) == 0
    _assert_all_current(state)
    lags = [int(a["version_lag_max"]) for a in auxes]
    assert max(lags) == K and lags[-1] == 0
    if s2w == "identity-wire":
        x, w = state["x"]["wq"].numpy(), state["w"]["wq"].numpy()
        assert np.linalg.norm(x - w) <= 0.065 * np.sqrt(x.shape[-1]) + 1e-5


def test_lag_beyond_ring_takes_full_resync():
    state, auxes = _run(steps=9, masks=_absence(start=2, k=6), resync=3)
    assert sum(int(a["resync_full"]) for a in auxes) == 1
    assert sum(int(a["resync_replayed"]) for a in auxes) == 0
    _assert_all_current(state)


def test_resync_off_leaves_state_and_aux_clean():
    state, auxes = _run(steps=2)
    assert "w_w" not in state and "resync" not in state
    assert not {"resync_replayed", "resync_full",
                "version_lag_max"} & set(auxes[0])


def test_resync_metrics_surface():
    _, auxes = _run(steps=2, resync=2, metrics=True)
    names = auxes[0]["metrics"].names()
    for want in ("part/worker_version_lag_max", "resync/replayed",
                 "resync/full"):
        assert want in names, want
        assert auxes[0]["metrics"][want].dtype == torch.float32


def test_resync_survives_all_absent_step():
    """Nobody hears round 1: the step is skipped, W, the ring and vv
    advance, and at step 2 everyone replays it, bit-consistent."""
    masks = [(1, 1, 1, 1), (0, 0, 0, 0), (1, 1, 1, 1)]
    state, auxes = _run(steps=3, masks=masks, resync=4)
    assert bool(auxes[1]["skipped"]) and int(auxes[1]["version_lag_max"]) == 1
    assert int(auxes[2]["resync_replayed"]) == 4
    _assert_all_current(state)
    assert state["resync"]["vv"].tolist() == [3] * 4


def test_resync_metrics_equal_reference():
    """The rejoin step's MetricSet from a carried state (worker 1 one
    round behind), against the reference's: the same names, the values
    within ``test_torch_obs.py``'s bounds, the three resync metrics
    exactly."""
    params, jmetas, tmetas, c = _quadratic(2)
    table = ((1, 1), (1, 0), (1, 1))
    cfg = _cfg(2, metrics=True)
    jopt = JEF21Muon(JEF21MuonConfig(use_pallas=False,
                                     participation=jpart.Explicit(table),
                                     **cfg))
    topt = EF21Muon(EF21MuonConfig(participation=Explicit(table), **cfg))
    hook = lambda t: t      # noqa: E731
    jfn = jopt.make_step(jmetas, reshard_payloads=hook)
    jstep = jax.jit(lambda s, b, t: jfn(s, _grad_jax, b, t))
    jb = {k: jnp.asarray(v) for k, v in c.items()}
    jstate = jopt.init(jax.random.key(0),
                       {k: jnp.asarray(v) for k, v in params.items()},
                       jmetas)
    for s in range(2):
        jstate, _ = jstep(jstate, jb, jnp.float32(0.02))
    tstate = state_from_jax(_np_tree(jstate))
    _, jaux = jstep(jstate, jb, jnp.float32(0.04))
    _, taux = topt.make_step(tmetas, reshard_payloads=hook)(
        tstate, _grad_torch, {k: torch.from_numpy(v) for k, v in c.items()},
        0.04)
    got, want = taux["metrics"], jaux["metrics"]
    assert got.names() == want.names()
    wf, gf = want.host_floats(), got.host_floats()
    for name, v in gf.items():
        np.testing.assert_allclose(v, wf[name], rtol=METRIC_RTOL, atol=1e-6,
                                   err_msg=name)
    assert (gf["resync/replayed"], gf["resync/full"],
            gf["part/worker_version_lag_max"]) == (1.0, 0.0, 0.0)


def test_profiler_capture_holds_the_replay_span():
    """With trace spans, one packed resync step under ``torch.profiler``
    on the CPU holds the replay's span beside the five phases."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.trace import PHASE_SPANS, RESYNC_SPAN
    params, _, tmetas, c = _quadratic(2)
    opt = EF21Muon(EF21MuonConfig(**_cfg(2, trace_spans=True)))
    state = opt.init(None, {k: torch.from_numpy(v.copy())
                            for k, v in params.items()}, tmetas)
    step = opt.make_step(tmetas, reshard_payloads=lambda t: t)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, _grad_torch, {k: torch.from_numpy(v)
                                  for k, v in c.items()}, 0.02)
    names = {e.name for e in prof.events()}
    assert RESYNC_SPAN == "resync/replay"
    for name in PHASE_SPANS + (RESYNC_SPAN,):
        assert name in names, name


def test_serve_full_resync_round_trips(tmp_path):
    state, _ = _run(steps=2, resync=2)
    path = str(tmp_path / "ck")
    save_checkpoint(path, state, step=2)
    w, version = resync.serve_full_resync(path, state)
    assert version == 2
    _assert_tree_bits(w, state_to_numpy(state)["w"], "w")


def test_serve_full_resync_rejects_non_optimizer_tree(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"params": torch.zeros(3)}, step=1)
    with pytest.raises(ValueError, match="no 'x' entry"):
        resync.serve_full_resync(path, {"params": torch.zeros(3)})


def _assert_states_equal(a, b):
    assert set(a) == set(b) and a["step"] == b["step"]
    for key in a:
        if key in ("step", "cw_state", "cs_state"):
            continue
        for u, v in zip(tree_leaves(a[key]), tree_leaves(b[key])):
            assert u.dtype == v.dtype and torch.equal(u, v), key


def test_resync_arms_bit_equal():
    """The staged packed, monolithic packed and unpacked arms leave the
    same state bit for bit, W_j included, but for the ring: its bytes
    follow each arm's layout, and the monolithic and unpacked rows are
    the same layout's pack."""
    ident = lambda t: t     # noqa: E731
    masks = _absence(start=2, k=2)
    staged, _ = _run(steps=5, hook=ident, masks=masks, resync=4)
    mono, _ = _run(steps=5, hook=ident, masks=masks, resync=4,
                   wire_stages=1)
    unpacked, _ = _run(steps=5, hook=ident, masks=masks, resync=4,
                       wire_pack_s2w=False)
    for other in (mono, unpacked):
        for key in ("x", "w", "w_w", "g_w", "m_w", "g_server"):
            _assert_states_equal({key: staged[key], "step": 0},
                                 {key: other[key], "step": 0})
    assert torch.equal(mono["resync"]["ring"], unpacked["resync"]["ring"])
    assert not torch.equal(staged["resync"]["ring"], mono["resync"]["ring"])
    assert torch.equal(staged["resync"]["vv"], mono["resync"]["vv"])


@pytest.mark.parametrize("packed", [False, True])
def test_resync_with_everyone_present_is_bit_equal_to_off(packed):
    hook = (lambda t: t) if packed else None
    on, auxes = _run(steps=4, hook=hook, resync=4)
    off, _ = _run(steps=4, hook=hook)
    _assert_states_equal({k: v for k, v in on.items()
                          if k not in ("w_w", "resync")}, off)
    _assert_all_current(on)
    assert [int(a["version_lag_max"]) for a in auxes] == [0] * 4


def test_resync_with_absences_keeps_the_trajectory_without_it():
    """Only an absent worker differentiates at a stale W_j, and its
    payload is masked out of the fold and its state frozen: x, W and the
    EF21 state are those of the same run without resync, bit for bit."""
    masks = _absence(start=2, k=5)
    on, _ = _run(steps=8, hook=lambda t: t, masks=masks, resync=3)
    off, _ = _run(steps=8, hook=lambda t: t, masks=masks)
    _assert_states_equal({k: v for k, v in on.items()
                          if k not in ("w_w", "resync")}, off)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("masks", [None, _absence(start=1, k=2)])
def test_donated_resync_step_is_bit_equal(packed, masks):
    """``donate``: W_j and the ring in place where the step is not
    elastic (the ring rolled slot by slot), the same bits either way."""
    hook = (lambda t: t) if packed else None
    plain, _ = _run(steps=4, hook=hook, masks=masks, resync=3)
    donated, _ = _run(steps=4, hook=hook, masks=masks, resync=3,
                      donate=True)
    _assert_states_equal(donated, plain)


def test_identity_s2w_with_resync_raises_the_reference_error():
    params, jmetas, tmetas, _ = _quadratic(2)
    cfg = dict(n_workers=2, w2s="top10", s2w="identity", resync=2)
    with pytest.raises(ValueError) as want:
        JEF21Muon(JEF21MuonConfig(use_pallas=False, **cfg)).init(
            jax.random.key(0), {k: jnp.asarray(v) for k, v in params.items()},
            jmetas)
    opt = EF21Muon(EF21MuonConfig(**cfg))
    with pytest.raises(ValueError) as got:
        opt.init(None, {k: torch.from_numpy(v) for k, v in params.items()},
                 tmetas)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="compressing s2w"):
        opt.make_step(tmetas)


# --------------------------------------------------------------- the CLI

CLI = ["--arch", "nanogpt-124m", "--reduced", "--steps", "12", "--seq",
       str(SEQ), "--batch", str(BATCH), "--workers", "2", "--w2s",
       "top10+natural", "--s2w", "natural", "--resync", "4", "--faults",
       "drop:w=1:steps=1-3,drop:w=1:steps=5-11", "--log-every", "4"]


def _summary(lines):
    return json.loads(lines[-1].split("RESYNC_SUMMARY ", 1)[1])


def _reference_counts(argv):
    """What the reference CLI's summary counts for ``argv``: its step's
    replay masks over its reception masks (the schedule AND the drops),
    summed over the steps as ``repro.launch.train`` sums them (the
    flags read by the port's parser, which has the reference's)."""
    a = train_cli.parse_args(argv)
    plan = jfaults.parse_faults(a.faults, a.workers, seed=a.seed)
    vv = jnp.zeros(a.workers, jnp.int32)
    replayed = full = lag = 0
    for step in range(a.steps):
        recv = jpart.reception_mask(a.participation, a.workers, step,
                                    a.participation_seed, faults=plan)
        rm = jresync.replay_masks(vv, step, recv, a.resync)
        replayed += int(rm.n_replayed)
        full += int(rm.n_full)
        lag, vv = int(rm.lag_max), rm.vv_new
    return {"resync_replayed": replayed, "resync_full": full,
            "version_lag_max": lag}


def test_cli_resync_header_and_summary_equal_reference(capsys, monkeypatch):
    """The drop schedule of ``chip_smoke.py``'s phase 8.7 on reduced
    nanogpt: the header field for field (``device=`` aside) against the
    reference CLI's, and the summary's replays (1), full copies (1) and
    last lag (0) against what the reference CLI counts for the run."""
    out = train_cli.main(CLI + ["--device", "cpu"])
    ours = capsys.readouterr().out.strip().splitlines()
    argv = list(CLI)
    argv[argv.index("--steps") + 1] = "0"     # the header, no steps
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain_cli.main()
    theirs = capsys.readouterr().out.strip().splitlines()
    assert ours[0].split()[:-1] == theirs[0].split()
    got = {k: _summary(ours)[k] for k in ("resync_replayed", "resync_full",
                                          "version_lag_max")}
    assert got == _reference_counts(CLI)
    assert got == {"resync_replayed": 1, "resync_full": 1,
                   "version_lag_max": 0}
    assert len(out["losses"]) == 12


def test_cli_resync_needs_a_compressing_s2w_like_reference(monkeypatch):
    argv = CLI[:CLI.index("--s2w")] + CLI[CLI.index("--resync"):]
    argv[argv.index("--steps") + 1] = "1"
    with pytest.raises(ValueError) as got:
        train_cli.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(ValueError) as want:
        jtrain_cli.main()
    assert str(got.value) == str(want.value)


# ------------------------------------------------ NaN bits of the f32 adds

def _smoke_constants():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def test_nan_bits_of_the_f32_adds_are_the_smokes_constants():
    """The reference's bits of the rejoin's ``w + delta`` and of the
    server's fold ``g_server + sum(d) / count`` on inputs with NaN
    payloads (quiet and signalling, both signs, one or both operands)
    are the constants ``chip_smoke.py`` holds the card's adds to."""
    sm = _smoke_constants()
    add = jax.jit(lambda a, b: a + b)
    got = np.asarray(add(_f32(sm.NAN_ADD_W), _f32(sm.NAN_ADD_DELTA)))
    assert tuple(int(v) for v in got.view(np.uint32)) == sm.NAN_ADD_WANT
    fold = jax.jit(lambda g, d, c: (g.astype(jnp.float32)
                                    + jnp.sum(d, axis=0) / c))
    got = np.asarray(fold(_f32(sm.NAN_FOLD_G),
                          _f32(sm.NAN_FOLD_D).reshape(2, -1),
                          np.float32(sm.NAN_FOLD_COUNT)))
    assert tuple(int(v) for v in got.view(np.uint32)) == sm.NAN_FOLD_WANT
