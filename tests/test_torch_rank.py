"""Parity of the port's low-rank compressors (RankK, RankK+Natural) with
the reference's, on their own and on the paths that run them: the
optimizer's state, the wire, the CLI and the step.

RankK compresses a slice X [m, n] as P = X Q, P <- NS(P), Qn = X^T P,
and keeps Qn as the next round's sketch. The port runs the same f32
algebra in other summation orders (the products, the NS chain, the norm
that normalises it), so its bf16 payloads and states equal the
reference's in almost every element and are at most one bf16 ulp of the
leaf's largest magnitude apart elsewhere (``assert_bf16_close``); Natural
then maps equal values to equal codes and signs. Both sides start from
one sketch: the reference's, carried across with ``state_from_jax``.
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

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core import compressors as J
from repro.core import error_feedback as jef
from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.core.muon import ParamMeta as JParamMeta
from repro.core.schedule import warmup_linear_decay as jwarmup_linear_decay
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist.layerwise import LayerPlan as JLayerPlan
from repro.dist.layerwise import vmap_n
from repro.dist.pipeline import s2w_issue_order as js2w_issue_order
from repro.kernels.bitpack import unpack_bits as junpack_bits
from repro.launch import train as jtrain_cli
from repro.models.api import abstract_params as jabstract_params
from repro.models.api import build_model as jbuild_model
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro.wire.layout import build_staged_layout as jbuild_staged_layout
from repro_torch.configs import get_config
from repro_torch.core import compressors as C
from repro_torch.core import error_feedback as ef
from repro_torch.core.muon import EF21Muon, EF21MuonConfig, ParamMeta
from repro_torch.core.schedule import warmup_linear_decay
from repro_torch.dist.layerwise import LayerPlan, leaf_paths, tree_get
from repro_torch.dist.pipeline import s2w_issue_order
from repro_torch.launch import train as train_cli
from repro_torch.models.api import (abstract_params, build_model,
                                    params_from_jax, state_from_jax)
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_threads import one_torch_thread  # noqa: F401

RANK_NAMES = ["rank5", "rank10", "rank15", "rank20", "rank10+natural",
              "rank15+natural"]
BF16_ULP = 2.0 ** -8       # one bf16 ulp, relative to a power of two
# the share of bf16 elements of a payload or state leaf that must be
# bit-equal to the reference's from the same inputs (measured: >= 99.77%
# on the slices below)
EQUAL_SHARE = 0.99


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def assert_bf16_close(got, want, share=EQUAL_SHARE, what=""):
    """bf16 ``got`` against ``want``: at least ``share`` of the elements
    bit-equal, and every element within one bf16 ulp of the leaf's
    largest magnitude (the f32 values may sit on either side of a
    rounding boundary; near zero an element's own ulp is finer than the
    error of the f32 algebra that made it)."""
    a, b = _f32(got), _f32(want)
    assert a.shape == b.shape, what
    eq = float(np.mean(a == b))
    assert eq >= share, f"{what}: {eq:.4%} bit-equal"
    scale = float(np.abs(b).max())
    bound = BF16_ULP * 2.0 ** math.ceil(math.log2(scale)) if scale else 0.0
    err = float(np.abs(a - b).max())
    assert err <= bound, f"{what}: {err} > {bound}"


def _rank_states(jc, lead, shape, seed):
    """The reference's init of one sketch per message, ``[*lead, n, r]``
    bf16, and the same bits as the port's state."""
    keys = jax.random.split(jax.random.key(seed), math.prod(lead)) \
        .reshape(lead)
    jst = vmap_n(lambda k: jc.init(k, shape, jnp.bfloat16), len(lead))(keys)
    return jst, params_from_jax(_np_tree(jst))


# --------------------------------------------------------- one EF21 round

@pytest.mark.parametrize("name", RANK_NAMES)
@pytest.mark.parametrize("shape,lead", [((96, 64), (2, 3)),
                                        ((48, 160), (2,)),
                                        ((256, 256), (1,))])
def test_rank_ef21_round_matches_reference(name, shape, lead):
    """One EF21 round, E' = E + C(T - E), from the same sketches: the
    payload (RankK's ``p``, ``q``) and the new sketch per
    ``assert_bf16_close``; RankK+Natural's codes and signs bit-equal
    wherever the bf16 values they encode are; the decompressed message
    within 1e-2 of its largest entry (RankK) or 1e-2 in Frobenius norm
    (with Natural, one power of two flipped by a one-ulp input changes a
    whole row of the product: measured up to 5.6e-2 of the largest entry,
    2.6e-5 in Frobenius norm)."""
    rng = np.random.default_rng(sum(shape) + len(lead))
    est = rng.standard_normal(lead + shape).astype(np.float32)
    tgt = rng.standard_normal(lead + shape).astype(np.float32)
    jc, c = J.get_compressor(name), C.get_compressor(name)
    jst, st = _rank_states(jc, lead, shape, 1)
    jpl, jst2, jnew = vmap_n(lambda s, a, b: jef.ef_compress_step(
        jc, s, a, b), len(lead))(jst, jnp.asarray(est), jnp.asarray(tgt))
    pl, st2, new = ef.ef_compress_step(c, st, torch.from_numpy(est),
                                       torch.from_numpy(tgt), shape)
    assert sorted(pl) == sorted(jpl)
    for k in pl:
        assert tuple(pl[k].shape) == tuple(jpl[k].shape), k
        assert str(pl[k].dtype).removeprefix("torch.") == str(jpl[k].dtype)
    assert st2["q"].dtype == torch.bfloat16
    assert_bf16_close(st2["q"], jst2["q"], what="state q")
    natural = name.endswith("+natural")
    if not natural:
        for k in ("p", "q"):
            assert_bf16_close(pl[k], jpl[k], what=k)
        d, jd = new.numpy() - est, np.asarray(jnew) - est
        np.testing.assert_allclose(d, jd, rtol=0,
                                   atol=1e-2 * np.abs(jd).max())
        return
    # the bf16 factors Natural encoded, from the same state and input
    diff = (torch.from_numpy(tgt) - torch.from_numpy(est)).to(torch.bfloat16)
    inner, _ = c.inner.compress(st, diff, shape)
    jinner = vmap_n(lambda s, x: jc.inner.compress(s, x)[0], len(lead))(
        jst, jnp.asarray(tgt - est).astype(jnp.bfloat16))
    for k in ("p", "q"):
        same = (_f32(inner[k]) == _f32(jinner[k])).reshape(lead + (-1,))
        np.testing.assert_array_equal(
            pl[k + "_codes"].numpy()[same],
            np.asarray(jpl[k + "_codes"])[same], err_msg=k)
        n = same.shape[-1]
        signs = [np.asarray(junpack_bits(np.asarray(s).reshape(-1),
                                         use_pallas=False))
                 .reshape(lead + (-1,))[..., :n]
                 for s in (pl[k + "_signs"].numpy(), jpl[k + "_signs"])]
        np.testing.assert_array_equal(signs[0][same], signs[1][same])
        assert same.mean() >= EQUAL_SHARE
    d, jd = new.numpy() - est, np.asarray(jnew) - est
    assert np.linalg.norm(d - jd) <= 1e-2 * np.linalg.norm(jd)
    # the same payload decompresses to the reference's values (f32
    # products over r terms, summed in two orders)
    jpl_t = {k: params_from_jax(np.asarray(v)) for k, v in jpl.items()}
    np.testing.assert_allclose(
        c.decompress(jpl_t, lead + shape, torch.float32).numpy(),
        np.asarray(vmap_n(lambda p: jc.decompress(p, shape, jnp.float32),
                          len(lead))(jpl)),
        rtol=0, atol=1e-6 * np.abs(jd).max())


def test_rankk_init_draws_one_normalised_sketch_per_message():
    """``q`` [*lead, n, r] in the wire dtype, drawn from the caller's
    generator only (the same seed, the same bits; torch's global
    generator untouched), columns of unit norm; on ``meta`` the shape
    alone, and without a generator it raises."""
    comp = C.RankK(fraction=0.1)
    before = torch.get_rng_state()
    a = comp.init(torch.Generator().manual_seed(3), (96, 64),
                  torch.bfloat16, (2, 3))["q"]
    b = comp.init(torch.Generator().manual_seed(3), (96, 64),
                  torch.bfloat16, (2, 3))["q"]
    assert torch.equal(torch.get_rng_state(), before)
    assert a.shape == (2, 3, 64, 7) and a.dtype == torch.bfloat16
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert not torch.equal(a[0, 0], a[0, 1])        # independent messages
    np.testing.assert_allclose(torch.linalg.norm(a.float(), dim=-2).numpy(),
                               1.0, atol=1e-2)
    meta = comp.init(None, (96, 64), torch.bfloat16, (2,), "meta")["q"]
    assert meta.shape == (2, 64, 7) and meta.device.type == "meta"
    with pytest.raises(ValueError, match="Generator"):
        comp.init(None, (96, 64), torch.bfloat16, (2,))
    with pytest.raises(ValueError, match="matrix"):
        comp.init(torch.Generator(), (96,), torch.bfloat16)


def test_rank_compress_of_a_strided_difference():
    """After a bucketed step a leaf of x can be a transposed view; the EF
    difference is made contiguous and RankK gives the payload of the
    contiguous operand, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 32, 48)).astype(np.float32)).mT.to(torch.bfloat16)
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 48, 32)).astype(np.float32))
    assert not x.is_contiguous()
    comp = C.get_compressor("rank10+natural")
    st = comp.init(torch.Generator().manual_seed(0), (48, 32),
                   torch.bfloat16, (2,))
    pl, st2 = ef.ef_compress(comp, st, w, x, (48, 32))
    want, wst = ef.ef_compress(comp, st, w, x.contiguous(), (48, 32))
    assert all(torch.equal(pl[k], want[k]) for k in want)
    assert torch.equal(st2["q"], wst["q"])


# ------------------------------------------------- optimizer state, init

def _tiny_tree():
    """test_torch_s2w.py's tiny tree, with a stacked leaf, a transposed
    pair and an incompressible vector; ``vec`` is a compressible vector,
    where a rank compressor falls back to TopK(0.25)."""
    rng = np.random.default_rng(0)
    shapes = {"wq": (48, 32), "wk": (48, 32), "w_in": (32, 80),
              "w_out": (80, 32), "blocks": (3, 48, 32), "bias": (32,),
              "vec": (40,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    metas = {"wq": ("spectral", 1.0, 0, True),
             "wk": ("spectral", 1.0, 0, True),
             "w_in": ("spectral", 1.5, 0, True),
             "w_out": ("spectral", 1.0, 0, True),
             "blocks": ("spectral", 2.0, 1, True),
             "bias": ("sign", 1.0, 0, False),
             "vec": ("sign", 1.0, 0, True)}
    return params, metas


def _opts(w2s, s2w, **kw):
    params, metas = _tiny_tree()
    cfg = dict(n_workers=2, beta=0.5, w2s=w2s, s2w=s2w, **kw)
    return (params, JEF21Muon(JEF21MuonConfig(use_pallas=False, **cfg)),
            {k: JParamMeta(*m) for k, m in metas.items()},
            EF21Muon(EF21MuonConfig(**cfg)),
            {k: ParamMeta(*m) for k, m in metas.items()})


def _grad_jax(params, c):
    loss = sum(jnp.sum(c[k] * p) + 0.5 * jnp.sum(p * p)
               for k, p in params.items())
    return loss, {k: c[k] + p for k, p in params.items()}


def _grad_torch(params, c):
    loss = sum(torch.sum(c[k] * p) + 0.5 * torch.sum(p * p)
               for k, p in params.items())
    return loss, {k: c[k] + p for k, p in params.items()}


def _coeffs(params, seed):
    return {k: np.random.default_rng(seed + i).standard_normal(
        (2,) + v.shape).astype(np.float32)
        for i, (k, v) in enumerate(params.items())}


def test_init_gives_one_sketch_per_message_as_the_reference():
    """``cw_state`` holds [n_workers, *stack, n, r] sketches and
    ``cs_state`` [*stack, n, r], in the reference's shapes and dtypes;
    fallback and identity leaves keep none. ``state_from_jax`` carries
    the reference's sketches bit for bit."""
    params, jopt, jmetas, topt, tmetas = _opts("rank10+natural",
                                               "rank10+natural")
    jstate = jopt.init(jax.random.key(0),
                       {k: jnp.asarray(v) for k, v in params.items()},
                       jmetas)
    tstate = topt.init(torch.Generator().manual_seed(0),
                       {k: torch.from_numpy(v) for k, v in params.items()},
                       tmetas)
    carried = state_from_jax(_np_tree(jstate))
    paths = leaf_paths(params)
    for key, lead in (("cw_state", (2,)), ("cs_state", ())):
        for i, path in enumerate(paths):
            want = _np_tree(tree_get(jstate[key], path))
            got, mine = carried[key][i], tstate[key][i]
            assert sorted(got) == sorted(mine) == sorted(want)
            if "q" not in want:
                assert path[0] in ("bias", "vec")
                continue
            stack = params[path[0]].shape[:-2]
            assert got["q"].dtype == mine["q"].dtype == torch.bfloat16
            slice_shape = params[path[0]].shape[-2:]
            assert mine["q"].shape == want["q"].shape == lead + stack + (
                slice_shape[1], C.RankK(0.1).rank_for(slice_shape))
            np.testing.assert_array_equal(got["q"].view(torch.int16).numpy(),
                                          want["q"].view(np.int16))
    with pytest.raises(ValueError, match="Generator"):
        topt.init(None, {k: torch.from_numpy(v) for k, v in params.items()},
                  tmetas)


def test_s2w_sketches_collapse_after_the_first_step():
    """A fact of the reference that the port keeps: EF21-P starts with
    W = X, so the server's first message compresses a zero difference;
    RankK's new sketch is then Qn = X^T P = 0, and every later P = X Qn
    is zero too, so a rank s2w leg sends zero factors from then on (its
    leaves of W stay at the initial params). Both sides, bit for bit;
    the w2s sketches stay alive (the first EF21 difference is beta * g)."""
    params, jopt, jmetas, topt, tmetas = _opts("rank10", "rank10+natural")
    jstep = jax.jit(lambda st, c, t: jopt.make_step(jmetas)(
        st, _grad_jax, c, t))
    tstep = topt.make_step(tmetas)
    jstate = jopt.init(jax.random.key(0),
                       {k: jnp.asarray(v) for k, v in params.items()},
                       jmetas)
    tstate = state_from_jax(_np_tree(jstate))
    for s in range(2):
        c = _coeffs(params, 100 + 10 * s)
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in c.items()},
                          jnp.float32(0.02))
        tstate, _ = tstep(tstate, _grad_torch,
                          {k: torch.from_numpy(v) for k, v in c.items()},
                          0.02)
    js = _np_tree(jstate)
    for i, path in enumerate(leaf_paths(params)):
        want = tree_get(js["cs_state"], path)
        if "q" in want:
            assert not np.any(want["q"].astype(np.float32))
            assert not bool(tstate["cs_state"][i]["q"].any())
            np.testing.assert_array_equal(tstate["w"][path[0]].numpy(),
                                          params[path[0]])
            assert bool(tstate["cw_state"][i]["q"].any())


@pytest.mark.parametrize("w2s,s2w", [("rank10", "identity"),
                                     ("rank10+natural", "rank10+natural"),
                                     ("top10", "rank10")])
def test_step_from_carried_state_on_tiny_tree(w2s, s2w):
    """One step from the reference's state after its first step (X != W,
    warm w2s sketches, and the s2w sketches of init: the step's own are
    zero, ``test_s2w_sketches_collapse_after_the_first_step``): w, g_w
    and g_server within 1e-2 in Frobenius norm (of the step's change for
    w); m_w within 1e-5 of its largest entry (the gradient is taken at
    W); cw_state and cs_state per ``assert_bf16_close``."""
    params, jopt, jmetas, topt, tmetas = _opts(w2s, s2w)
    jstep = jax.jit(lambda st, c, t: jopt.make_step(
        jmetas, reshard_payloads=lambda b: b)(st, _grad_jax, c, t))
    tstep = topt.make_step(tmetas, reshard_payloads=lambda b: b)
    jstate = jopt.init(jax.random.key(0),
                       {k: jnp.asarray(v) for k, v in params.items()},
                       jmetas)
    jinit = jstate
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in
                               _coeffs(params, 100).items()},
                      jnp.float32(0.02))
    if s2w != "identity":
        jstate = {**jstate, "cs_state": jinit["cs_state"]}
    w_before = _np_tree(jstate.get("w"))
    tstate = state_from_jax(_np_tree(jstate))
    c = _coeffs(params, 200)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in c.items()},
                      jnp.float32(0.04))
    tstate, _ = tstep(tstate, _grad_torch,
                      {k: torch.from_numpy(v) for k, v in c.items()}, 0.04)
    js = _np_tree(jstate)
    for k in params:
        np.testing.assert_allclose(tstate["m_w"][k].numpy(), js["m_w"][k],
                                   rtol=0,
                                   atol=1e-5 * np.abs(js["m_w"][k]).max())
        for key in ("g_w", "g_server"):
            a, b = tstate[key][k].numpy(), js[key][k]
            assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b), key
        if s2w != "identity":
            a, b = tstate["w"][k].numpy(), js["w"][k]
            assert np.linalg.norm(a - b) <= \
                1e-2 * np.linalg.norm(b - w_before[k]), k
    for i, path in enumerate(leaf_paths(params)):
        for key in ("cw_state", "cs_state")[:1 + (s2w != "identity")]:
            want = tree_get(js[key], path)
            if "q" in want:
                assert bool(np.any(want["q"].astype(np.float32)))
                assert_bf16_close(tstate[key][i]["q"], want["q"],
                                  share=0.9, what=f"{key} {path}")


def _run_port(w2s, s2w, hooks, steps=3):
    params, metas = _tiny_tree()
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    states = []
    for hook, extra in hooks:
        opt = EF21Muon(EF21MuonConfig(n_workers=2, beta=0.5, w2s=w2s,
                                      s2w=s2w, **extra))
        state = opt.init(torch.Generator().manual_seed(0),
                         {k: torch.from_numpy(v) for k, v in params.items()},
                         tmetas)
        step = opt.make_step(tmetas, reshard_payloads=hook)
        for s in range(steps):
            state, _ = step(state, _grad_torch,
                            {k: torch.from_numpy(v) for k, v in
                             _coeffs(params, 100 + 10 * s).items()},
                            0.02 * (s + 1))
        states.append(state)
    return states


@pytest.mark.parametrize("w2s,s2w", [("rank10", "identity"),
                                     ("rank10+natural", "rank10+natural")])
def test_rank_arms_bit_equal(w2s, s2w):
    """The packed staged, packed monolithic (``wire_stages=1``), unpacked
    s2w (``wire_pack_s2w=False``), unpacked w2s (``wire_pack=False``) and
    hook-less arms leave the same state bit for bit after 3 steps, the
    sketches included."""
    ident = lambda t: t     # noqa: E731
    base, *others = _run_port(w2s, s2w, [
        (None, {}), (ident, {}), (ident, dict(wire_stages=1)),
        (ident, dict(wire_pack_s2w=False)), (ident, dict(wire_pack=False))])
    for other in others:
        for key in ("x", "g_server", "g_w", "m_w") + (
                ("w",) if s2w != "identity" else ()):
            for k in base[key]:
                assert torch.equal(other[key][k], base[key][k]), (key, k)
        for key in ("cw_state",) + (("cs_state",) if s2w != "identity"
                                    else ()):
            for a, b in zip(other[key], base[key]):
                assert sorted(a) == sorted(b)
                assert all(torch.equal(a[n], b[n]) for n in a), key


# -------------------------------------------------------------- the wire

def _plans(w2s, s2w, reduced=True):
    jcfg, cfg = jget_config("nanogpt-124m"), get_config("nanogpt-124m")
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jshapes, jmetas = jabstract_params(jbuild_model(jcfg))
    shapes, metas = abstract_params(build_model(cfg))
    return (JLayerPlan.build(jshapes, jmetas, w2s=w2s, s2w=s2w),
            LayerPlan.build(shapes, metas, w2s=w2s, s2w=s2w))


PAIRS = [("rank10", "identity"), ("rank10+natural", "rank10+natural"),
         ("rank10", "rank10"), ("rank15+natural", "rank5")]


@pytest.mark.parametrize("w2s,s2w", PAIRS)
def test_reduced_nanogpt_rank_layouts_equal_reference(w2s, s2w):
    """Both directions: the monolithic and staged layouts (offsets, slice
    bytes, codecs), the stage partition, the s2w issue order and the
    wire budget, against the reference's."""
    jplan, plan = _plans(w2s, s2w)
    assert [lp.w2s.name for lp in plan.leaves] == \
        [lp.w2s.name for lp in jplan.leaves]
    sp, jsp = plan.stage_plan(), jplan.stage_plan()
    for direction in ("w2s", "s2w"):
        layout = plan.wire_layout(torch.bfloat16, direction)
        jlayout = jplan.wire_layout(jnp.bfloat16, direction=direction)
        assert layout.describe() == jlayout.describe()
        assert layout.total_nbytes == jlayout.total_nbytes
        sw = plan.staged_wire_layout(torch.bfloat16, sp, direction)
        jsw = jplan.staged_wire_layout(jnp.bfloat16, jsp,
                                       direction=direction)
        assert [s.describe() for s in sw.stages] == \
            [s.describe() for s in jsw.stages]
    assert s2w_issue_order(plan, sp) == js2w_issue_order(jplan, jsp)
    shapes, metas = abstract_params(build_model(
        get_config("nanogpt-124m").reduced()))
    jshapes, jmetas = jabstract_params(jbuild_model(
        jget_config("nanogpt-124m").reduced()))
    kw = dict(n_workers=2, w2s=w2s, s2w=s2w)
    b = EF21Muon(EF21MuonConfig(**kw)).wire_budget(shapes, metas)
    jb = JEF21Muon(JEF21MuonConfig(**kw)).wire_budget(jshapes, jmetas)
    assert (b.pack_w2s, b.pack_s2w, b.n_stages, b.w2s_sizes, b.s2w_sizes,
            b.two_way_nbytes) == (jb.pack_w2s, jb.pack_s2w, jb.n_stages,
                                  jb.w2s_sizes, jb.s2w_sizes,
                                  jb.two_way_nbytes)


@pytest.mark.parametrize("w2s,s2w,w2s_stages,s2w_stages", [
    ("rank10", "identity", (8_294_656, 14_192_640, 11_354_112), ()),
    ("rank10+natural", "rank10+natural",
     (4_732_944, 7_983_360, 6_386_688), (4_732_944, 7_983_360, 6_386_688))])
def test_full_nanogpt_rank_bytes_pinned(w2s, s2w, w2s_stages, s2w_stages):
    """Full-width nanogpt-124m on meta tensors, 2 workers: the stage
    buffers of both directions, the broadcasts' issue order and the
    monolithic wire (``BENCH_wire.json``'s rank10+natural row:
    19,102,992 B a worker), against the reference's and pinned."""
    jplan, plan = _plans(w2s, s2w, reduced=False)
    shapes, metas = abstract_params(build_model(get_config("nanogpt-124m")))
    b = EF21Muon(EF21MuonConfig(n_workers=2, w2s=w2s, s2w=s2w)) \
        .wire_budget(shapes, metas)
    assert b.w2s_sizes == w2s_stages and b.s2w_sizes == s2w_stages
    assert s2w_issue_order(plan, plan.stage_plan()) == (1, 0, 2)
    if w2s == "rank10+natural":
        assert plan.wire_layout(torch.bfloat16).total_nbytes == 19_102_992
    # every rank leaf's rank is ceil(0.1 * min(m, n)) = 77
    ranks = {lp.w2s.rank_for(lp.slice_shape) for lp in plan.leaves
             if "rank" in lp.w2s.name}
    assert ranks == {77}
    for direction in ("w2s", "s2w"):
        assert plan.wire_layout(torch.bfloat16, direction).describe() == \
            jplan.wire_layout(jnp.bfloat16, direction=direction).describe()


def _payloads(jplan, direction, lead, seed):
    """Reference payloads of random messages under each leaf's
    ``direction`` compressor, with [lead, *stack] leading dims, from
    sketches drawn by the reference's init."""
    rng = np.random.default_rng(seed)
    out = []
    for i, lp in enumerate(jplan.leaves):
        c = getattr(lp, direction)
        x = jnp.asarray(rng.standard_normal((lead,) + lp.shape), jnp.float32)
        if not getattr(c, "lossless_wire", False):
            x = x.astype(jnp.bfloat16)
        dims = lp.meta.stack_dims + 1
        keys = jax.random.split(jax.random.key(i), lead * lp.n_stack) \
            .reshape((lead,) + lp.stack_shape)
        states = vmap_n(lambda k, c=c, s=lp.slice_shape: c.init(
            k, s, jnp.bfloat16), dims)(keys)
        out.append(vmap_n(lambda st, s, c=c: c.compress(st, s)[0],
                          dims)(states, x))
    return out


def _to_torch(pl):
    conv = lambda v: params_from_jax(np.asarray(v))   # noqa: E731
    return {k: conv(v) for k, v in pl.items()} if isinstance(pl, dict) \
        else conv(pl)


@pytest.mark.parametrize("w2s,s2w", PAIRS[:2])
@pytest.mark.parametrize("direction", ["w2s", "s2w"])
def test_rank_buffers_byte_equal_to_reference(w2s, s2w, direction):
    """The reference's payloads packed by the port's layouts (monolithic
    and per stage) equal the reference's buffers byte for byte, and
    unpack gives the payloads back bit for bit."""
    jplan, plan = _plans(w2s, s2w)
    lead = 2 if direction == "w2s" else 1
    jpls = _payloads(jplan, direction, lead, 5)
    pls = [_to_torch(p) for p in jpls]
    jlayout = jplan.wire_layout(jnp.bfloat16, direction=direction)
    layout = plan.wire_layout(torch.bfloat16, direction)
    buf = layout.pack(pls)
    assert buf.shape == (lead, layout.total_nbytes)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jlayout.pack(jpls)))
    jsw = jbuild_staged_layout(
        jlayout, [s.leaf_ids for s in jplan.stage_plan().stages])
    sw = plan.staged_wire_layout(torch.bfloat16, plan.stage_plan(),
                                 direction)
    for k in range(sw.n_stages):
        sbuf = sw.pack_stage(k, pls)
        np.testing.assert_array_equal(sbuf.numpy(),
                                      np.asarray(jsw.pack_stage(k, jpls)))
        for i, got in zip(sw.stage_leaf_ids[k], sw.unpack_stage(k, sbuf)):
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(pls[i])):
                assert a.dtype == b.dtype and torch.equal(a, b)


# ----------------------------------------------------------------- the CLI

@pytest.mark.parametrize("flags,fields", [
    (["--w2s", "rank10"], {"w2s_bytes/worker=457728",
                           "wire_buffer=462848", "wire_stages=3"}),
    (["--w2s", "rank10+natural", "--s2w", "rank10+natural"],
     {"w2s_bytes/worker=259712", "wire_buffer=264832",
      "s2w_bytes/round=259712", "s2w_wire_buffer=264832",
      "two_way_wire=529664", "wire_stages=3"})])
def test_cli_header_rank_equals_reference(flags, fields, capsys,
                                          monkeypatch):
    """The ``rank*`` names run through the CLI (they raised until this
    slice); the header equals the reference CLI's field for field,
    ``device=`` aside."""
    argv = ["--arch", "nanogpt-124m", "--reduced", "--steps", "0", "--seq",
            "16", "--batch", "2", "--workers", "2"] + flags
    train_cli.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()[0].split()
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain_cli.main()
    theirs = capsys.readouterr().out.splitlines()[0].split()
    assert ours[-1] == "device=cpu"
    assert ours[:-1] == theirs
    assert fields <= set(ours)


def test_cli_runs_the_two_way_rank_step(capsys):
    out = train_cli.main(["--arch", "nanogpt-124m", "--reduced", "--steps",
                          "2", "--seq", "16", "--batch", "2", "--workers",
                          "2", "--w2s", "rank10+natural", "--s2w",
                          "rank10+natural", "--log-every", "1",
                          "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(map(math.isfinite,
                                               out["losses"]))
    lines = capsys.readouterr().out.strip().splitlines()
    # the header, a loss line a step, the reference's summary line last
    assert lines[0].startswith("arch=nanogpt-124m ")
    assert [json.loads(x)["step"] for x in lines
            if x.startswith('{"step"')] == [0, 1]
    assert lines[-1].startswith("RESYNC_SUMMARY ")


# ------------------------------------------------- the slice, reduced nanogpt

SEQ, BATCH, WORKERS, STEPS = 32, 4, 2, 10
TWO_WAY = dict(n_workers=WORKERS, beta=0.5, w2s="rank10+natural",
               s2w="rank10+natural")


@pytest.fixture(scope="module")
def reduced_two_way():
    """The reference's reduced-nanogpt trainer, two-way rank10+natural,
    its jitted step and initial state, and its batches."""
    jcfg = jget_config("nanogpt-124m").reduced()
    jmodel = jbuild_model(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    data = JSyntheticLM(jcfg, JShapeSpec("t", "train", SEQ, BATCH),
                        n_workers=WORKERS, seed=0)
    jtr = JTrainer(jmodel, JTrainerConfig(remat=False, use_pallas=False,
                                          **TWO_WAY))
    return (jtr.jit_step(None), jtr.opt.init(jax.random.key(1), jparams,
                                             jtr.metas), data)


def _batch(jb):
    return {k: torch.from_numpy(np.array(v)).to(torch.int64)
            for k, v in jb.items()}


def _port_trainer():
    return Trainer(build_model(get_config("nanogpt-124m").reduced()),
                   TrainerConfig(**TWO_WAY), device="cpu")


def test_two_way_rank_step_from_carried_state(reduced_two_way):
    """Reduced nanogpt, one two-way rank10+natural step from the
    reference's state after one step (X != W, warm w2s sketches) with the
    s2w sketches of init (the step's own are zero): the gradients at W
    summed in another order make m_w differ by ~1e-6, so both EF rounds
    see other inputs. w, g_w and g_server within 1e-2 in Frobenius norm
    per leaf (of the step's change for w); m_w within 1e-5; cw_state and
    cs_state per ``assert_bf16_close`` with 95% bit-equal; x of the
    spectral leaves within 1e-3, and of the sign leaves at most 1e-3 of
    the elements apart (a sign flip of g_server moves x by twice the
    radius). Measured: w 1.5e-4, g_w and g_server 4.4e-3, m_w 1.1e-6,
    cw_state 97.4% and cs_state 99.8% bit-equal, spectral x 3.6e-4, sign
    x 9.2e-5 of the elements."""
    jstep, jinit, data = reduced_two_way
    jstate, _ = jstep(jinit, data.batch_at(0), jnp.float32(0.004))
    jstate = {**jstate, "cs_state": jinit["cs_state"]}
    tr = _port_trainer()
    state = state_from_jax(_np_tree(jstate))
    w_before = _np_tree(jstate["w"])
    jstate, _ = jstep(jstate, data.batch_at(1), jnp.float32(0.008))
    state, _ = tr.make_step()(state, _batch(data.batch_at(1)),
                              np.float32(0.008))
    js = _np_tree(jstate)
    plan = tr.layer_plan()
    for i, (path, lp) in enumerate(zip(leaf_paths(js["x"]), plan.leaves)):
        a, b = tree_get(state["w"], path).numpy(), tree_get(js["w"], path)
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(
            b - tree_get(w_before, path)), path
        for key in ("g_w", "g_server", "m_w"):
            a = tree_get(state[key], path).numpy()
            b = tree_get(js[key], path)
            tol = 1e-5 if key == "m_w" else 1e-2
            assert np.linalg.norm(a - b) <= tol * np.linalg.norm(b), \
                (key, path)
        a = tree_get(state["x"], path).float().numpy()
        b = tree_get(js["x"], path).astype(np.float32)
        if lp.meta.lmo == "spectral":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
        else:
            assert np.mean(a != b) <= 1e-3, path
        for key in ("cw_state", "cs_state"):
            want = tree_get(js[key], path)
            assert sorted(state[key][i]) == sorted(want)
            if "q" in want:
                assert_bf16_close(state[key][i]["q"], want["q"], share=0.95,
                                  what=f"{key} {path}")


# The 10-step two-way curves: unlike TopK, RankK meets no bf16 ties that
# pick which entries are sent, so the port's and the reference's losses
# stay within f32 rounding (measured: at most 4.8e-7 over all 10 steps).
LOSS_ATOL = 1e-5


def test_two_way_rank_trajectory_tracks_reference(reduced_two_way):
    """The slice as a whole: reduced nanogpt, 2 workers, beta 0.5,
    ``--w2s rank10+natural --s2w rank10+natural``, from the reference's
    initial state (params and sketches) on its batches, 10 steps: the
    loss curve within LOSS_ATOL of the reference's."""
    jstep, jstate, data = reduced_two_way
    tr = _port_trainer()
    state = state_from_jax(_np_tree(jstate))
    step = tr.make_step()
    jsched = jwarmup_linear_decay(0.01, 3, STEPS)
    sched = warmup_linear_decay(0.01, 3, STEPS)
    jl, tl = [], []
    for i in range(STEPS):
        jb = data.batch_at(i)
        jstate, jaux = jstep(jstate, jb, jsched(i))
        state, aux = step(state, _batch(jb), sched(i))
        jl.append(float(jaux["loss"]))
        tl.append(float(aux["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_ATOL)
    assert set(state) == set(jstate)
