"""Parity of the port's optimizer layers with the reference's.

Compressors, error feedback, LMOs, norms, schedule, the layer plan, NS
buckets and the EF21-Muon step, each fed the same numpy inputs on both
sides. Integer and selection logic (TopK indices, leaf order, buckets,
wire-byte accounting, the schedule, the EF21 state) must agree exactly;
what passes through Newton-Schulz agrees within f32 tolerances stated
where they are used.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import compressors as jcomp
from repro.core import error_feedback as jef
from repro.core import lmo as jlmo
from repro.core import norms as jnorms
from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.core.muon import ParamMeta as JParamMeta
from repro.core.schedule import warmup_linear_decay as jwarmup_linear_decay
from repro.dist.layerwise import LayerPlan as JLayerPlan
from repro.models.api import abstract_params as jabstract_params
from repro.models.api import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.core import compressors as comp
from repro_torch.core import error_feedback as ef
from repro_torch.core import lmo, norms
from repro_torch.core.muon import EF21Muon, EF21MuonConfig, ParamMeta
from repro_torch.core.schedule import warmup_linear_decay
from repro_torch.dist.layerwise import LayerPlan
from repro_torch.models.api import abstract_params, build_model
from test_torch_threads import one_torch_thread  # noqa: F401

# x after NS-driven LMO steps: the per-step f32 NS difference (~1e-6 of a
# unit-spectral-norm direction) times the radius, accumulated over steps;
# ROADMAP Queue 3 measured 2.4e-7 between two reference arms.
X_ATOL = 1e-6


def _np(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _bf16_pair(shape, seed):
    """The same bf16 values on both sides (the payload is bf16 on the
    wire, so TopK sees bf16 magnitudes with many ties)."""
    j = jnp.asarray(_np(shape, seed)).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)
    return j, t


# ------------------------------------------------------------- compressors

def test_topk_tie_order_matches_lax_top_k():
    """On [1,3,3,2,3,3] with k=3, jax.lax.top_k gives [1,2,4] (lower
    index first among ties); torch.topk would give [1,5,4]."""
    x = [1.0, 3.0, 3.0, 2.0, 3.0, 3.0]
    jp, _ = jcomp.TopK(0.5).compress({}, jnp.asarray(x, jnp.bfloat16))
    tp, _ = comp.TopK(0.5).compress(
        {}, torch.tensor(x, dtype=torch.bfloat16), (6,))
    assert np.asarray(jp["indices"]).tolist() == [1, 2, 4]
    assert tp["indices"].tolist() == [1, 2, 4]


@pytest.mark.parametrize("name", ["top5", "top10", "top15", "top20"])
@pytest.mark.parametrize("shape", [(64, 96), (256, 256)])
def test_topk_payload_equals_reference_on_bf16_ties(name, shape):
    """Index sets (and their order) and values equal the reference's
    exactly on bf16 normals, where ties at the k-th magnitude abound."""
    j, t = _bf16_pair(shape, 11)
    n_distinct = np.unique(np.abs(np.asarray(j.astype(jnp.float32)))).size
    assert n_distinct < j.size // 4          # the inputs do tie
    jp, _ = jcomp.get_compressor(name).compress({}, j)
    tp, _ = comp.get_compressor(name).compress({}, t, shape)
    np.testing.assert_array_equal(tp["indices"].numpy(),
                                  np.asarray(jp["indices"]))
    np.testing.assert_array_equal(
        tp["values"].float().numpy(),
        np.asarray(jp["values"].astype(jnp.float32)))
    jd = jcomp.get_compressor(name).decompress(jp, shape, jnp.float32)
    td = comp.get_compressor(name).decompress(tp, shape, torch.float32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_topk_leading_dims_are_independent_messages():
    """A [W, L, m, n] tensor compresses as W*L slices, as the reference's
    vmap over worker and stack dims does."""
    j, t = _bf16_pair((2, 3, 16, 24), 12)
    c, jc = comp.TopK(0.1), jcomp.TopK(0.1)
    tp, _ = c.compress({}, t, (16, 24))
    jp = jax.vmap(jax.vmap(lambda s: jc.compress({}, s)[0]))(j)
    np.testing.assert_array_equal(tp["indices"].numpy(),
                                  np.asarray(jp["indices"]))
    assert c.payload_bytes((16, 24), torch.bfloat16) \
        == jc.payload_bytes((16, 24), jnp.bfloat16)


@pytest.mark.parametrize("name", ["top10", "identity"])
def test_ef_compress_step_bit_equal(name):
    """One EF21 round: payload and new estimate bit-equal, including the
    lossless (f32) wire of Identity."""
    est, tgt = _np((48, 32), 13), _np((48, 32), 14)
    jpl, _, jnew = jef.ef_compress_step(jcomp.get_compressor(name), {},
                                        jnp.asarray(est), jnp.asarray(tgt))
    tpl, _, tnew = ef.ef_compress_step(comp.get_compressor(name), {},
                                       torch.from_numpy(est),
                                       torch.from_numpy(tgt), (48, 32))
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    back = ef.apply_payload(comp.get_compressor(name), tpl,
                            torch.from_numpy(est))
    np.testing.assert_array_equal(back.numpy(), np.asarray(jnew))


def test_unported_compressors_and_archs_point_to_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("qwen2-vl-7b")
    assert get_config("deepseek-v3-671b").mla is not None   # ported
    with pytest.raises(KeyError):
        comp.get_compressor("no-such")


# --------------------------------------------------------- LMOs and norms

@pytest.mark.parametrize("kind", ["spectral", "sign", "euclid", "col_l2",
                                  "row_l2", "nuclear"])
@pytest.mark.parametrize("shape", [(48, 32), (32, 80)])
def test_lmo_direction_matches_reference(kind, shape):
    g = _np(shape, 15)
    want = np.asarray(jlmo.lmo_direction(jnp.asarray(g), kind,
                                         use_pallas=False))
    got = lmo.lmo_direction(torch.from_numpy(g), kind).numpy()
    # NS / power-iteration chains in f32 (see test_torch_kernels.py)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        lmo.sharp(torch.from_numpy(g), kind).numpy(),
        np.asarray(jlmo.sharp(jnp.asarray(g), kind, use_pallas=False)),
        rtol=1e-4, atol=1e-4)


def test_lmo_batched_and_radius_scale_match_reference():
    g = _np((3, 40, 72), 16)
    np.testing.assert_allclose(
        lmo.lmo_direction_batched(torch.from_numpy(g)).numpy(),
        np.asarray(jlmo.lmo_direction_batched(jnp.asarray(g),
                                              use_pallas=False)),
        rtol=1e-4, atol=1e-5)
    for shape in ((768, 3072), (3072, 768), (64,), (32, 32)):
        for kind in ("spectral", "sign"):
            assert lmo.default_radius_scale(shape, kind) \
                == jlmo.default_radius_scale(shape, kind)


@pytest.mark.parametrize("kind", sorted(jnorms.DUAL))
def test_norms_match_reference(kind):
    x = _np((24, 40), 17)
    np.testing.assert_allclose(norms.norm(torch.from_numpy(x), kind).item(),
                               float(jnorms.norm(jnp.asarray(x), kind)),
                               rtol=1e-5)
    if kind in ("frobenius", "spectral", "linf", "l1", "col_l2", "row_l2"):
        assert norms.norm_equivalence_constants((24, 40), kind) \
            == jnorms.norm_equivalence_constants((24, 40), kind)


def test_warmup_linear_decay_equals_reference():
    j, t = jwarmup_linear_decay(0.02, 5, 50), warmup_linear_decay(0.02, 5, 50)
    for step in range(60):
        assert np.float32(t(step)) == np.float32(j(step)), step


# ------------------------------------------------------ plan and buckets

def _tiny_tree(seed=0):
    """Params/metas like tests/test_ns_bucketing.py::_tiny_tree: a same-
    shape group, a transposed pair sharing a bucket, a stacked leaf and a
    non-spectral, incompressible leaf — as numpy, for both sides."""
    shapes = {"wq": (48, 32), "wk": (48, 32), "w_in": (32, 80),
              "w_out": (80, 32), "blocks": (3, 48, 32), "bias": (32,)}
    params = {k: _np(s, seed + i) for i, (k, s) in enumerate(shapes.items())}
    metas = {"wq": ("spectral", 1.0, 0, True),
             "wk": ("spectral", 1.0, 0, True),
             "w_in": ("spectral", 1.5, 0, True),
             "w_out": ("spectral", 1.0, 0, True),
             "blocks": ("spectral", 2.0, 1, True),
             "bias": ("sign", 1.0, 0, False)}
    return params, metas


def _bucket_fields(b):
    return (tuple(b.shape), b.leaf_ids, tuple(map(tuple, b.leaf_shapes)),
            b.transposes, b.counts, b.radius_scales)


def test_plan_and_buckets_match_reference_on_tiny_tree():
    params, metas = _tiny_tree()
    jplan = JLayerPlan.build({k: jnp.asarray(v) for k, v in params.items()},
                             {k: JParamMeta(*m) for k, m in metas.items()},
                             w2s="top10")
    tplan = LayerPlan.build({k: torch.from_numpy(v)
                             for k, v in params.items()},
                            {k: ParamMeta(*m) for k, m in metas.items()},
                            w2s="top10")
    jpaths = [path[0].key for path, _ in
              jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [p[0] for p in tplan.paths] == jpaths
    assert [lp.shape for lp in tplan.leaves] == \
        [lp.shape for lp in jplan.leaves]
    assert [_bucket_fields(b) for b in tplan.ns_buckets()] == \
        [_bucket_fields(b) for b in jplan.ns_buckets()]
    assert tplan.w2s_bytes_per_worker(torch.bfloat16) == \
        jplan.w2s_bytes_per_worker(jnp.bfloat16)


def test_nanogpt_plan_buckets_and_wire_bytes_match_reference():
    """Full-width nanogpt-124m, shapes only: leaf order, the two NS
    buckets ((768,768) = wk, wo, wq, wv x12; (768,3072) = w_down
    transposed, w_up x12) and the Table-2 bytes equal the reference's."""
    jshapes, jmetas = jabstract_params(jbuild_model(jget_config(
        "nanogpt-124m")))
    jplan = JLayerPlan.build(jshapes, jmetas, w2s="top10")
    tshapes, tmetas = abstract_params(build_model(get_config(
        "nanogpt-124m")))
    tplan = LayerPlan.build(tshapes, tmetas, w2s="top10")
    jpaths = ["/".join(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]]
    assert ["/".join(p) for p in tplan.paths] == jpaths
    assert [(lp.shape, lp.meta.lmo, lp.meta.radius_scale,
             lp.meta.stack_dims, lp.meta.compressible)
            for lp in tplan.leaves] == \
        [(lp.shape, lp.meta.lmo, lp.meta.radius_scale, lp.meta.stack_dims,
          lp.meta.compressible) for lp in jplan.leaves]
    tb = tplan.ns_buckets()
    assert [_bucket_fields(b) for b in tb] == \
        [_bucket_fields(b) for b in jplan.ns_buckets()]
    assert [(b.shape, b.batch) for b in tb] == [((768, 768), 48),
                                                ((768, 3072), 24)]
    assert tplan.w2s_bytes_per_worker(torch.bfloat16) == \
        jplan.w2s_bytes_per_worker(jnp.bfloat16)
    assert tplan.dense_bytes(torch.bfloat16) == \
        jplan.dense_bytes(jnp.bfloat16)


def test_bucket_stack_unstack_are_inverses():
    params, metas = _tiny_tree()
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    plan = LayerPlan.build(tparams, {k: ParamMeta(*m)
                                     for k, m in metas.items()})
    flat = plan.flatten(tparams)
    for b in plan.ns_buckets():
        back = b.unstack(b.stack([flat[i] for i in b.leaf_ids]))
        for i, piece in zip(b.leaf_ids, back):
            assert torch.equal(piece, flat[i])


# ------------------------------------------------------------ the step

def _grad_fn_jax(params, batch):
    # gradients handed in by the batch: identical bits on both sides
    return sum(jnp.sum(p) for p in params.values()), dict(batch)


def _grad_fn_torch(params, batch):
    return sum(torch.sum(p) for p in params.values()), dict(batch)


def _run_both(w2s, ns_bucketing, steps, n_workers=2, beta=0.5):
    params, metas = _tiny_tree()
    kw = dict(n_workers=n_workers, beta=beta, w2s=w2s,
              ns_bucketing=ns_bucketing)
    jopt = JEF21Muon(JEF21MuonConfig(use_pallas=False, **kw))
    topt = EF21Muon(EF21MuonConfig(**kw))
    jmetas = {k: JParamMeta(*m) for k, m in metas.items()}
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    jstate = jopt.init(jax.random.key(0),
                       {k: jnp.asarray(v) for k, v in params.items()},
                       jmetas)
    tstate = topt.init(None, {k: torch.from_numpy(v)
                              for k, v in params.items()}, tmetas)
    jstep, tstep = jopt.make_step(jmetas), topt.make_step(tmetas)
    for s in range(steps):
        grads = {k: _np((n_workers,) + v.shape, 100 + 7 * s + i)
                 for i, (k, v) in enumerate(params.items())}
        t = 0.02 * (s + 1)
        jstate, jaux = jstep(jstate, _grad_fn_jax,
                             {k: jnp.asarray(g) for k, g in grads.items()}, t)
        tstate, taux = tstep(tstate, _grad_fn_torch,
                             {k: torch.from_numpy(g)
                              for k, g in grads.items()}, t)
    return jstate, tstate, jaux, taux


@pytest.mark.parametrize("w2s", ["top10", "identity", "top10+natural",
                                 "natural"])
@pytest.mark.parametrize("ns_bucketing", [True, False])
@pytest.mark.parametrize("steps", [1, 3])
def test_ef21_muon_step_matches_reference(w2s, ns_bucketing, steps):
    """EF21 state (g_w, m_w, g_server) bit-equal to the reference's after
    1 and 3 steps; x within X_ATOL (it is NS-derived)."""
    jstate, tstate, jaux, taux = _run_both(w2s, ns_bucketing, steps)
    assert tstate["step"] == int(jstate["step"]) == steps
    for key in ("g_w", "m_w", "g_server"):
        for k in jstate[key]:
            np.testing.assert_array_equal(tstate[key][k].numpy(),
                                          np.asarray(jstate[key][k]),
                                          err_msg=f"{key}/{k}")
    for k in jstate["x"]:
        np.testing.assert_allclose(tstate["x"][k].numpy(),
                                   np.asarray(jstate["x"][k]), rtol=0,
                                   atol=X_ATOL, err_msg=f"x/{k}")
    np.testing.assert_allclose(taux["grad_est_norm"].item(),
                               float(jaux["grad_est_norm"]), rtol=1e-6)


def test_ef21_muon_without_momentum_matches_reference():
    jstate, tstate, _, _ = _run_both("top10", True, 2, beta=1.0)
    assert tstate["m_w"] is None and jstate["m_w"] is None
    for k in jstate["g_w"]:
        np.testing.assert_array_equal(tstate["g_w"][k].numpy(),
                                      np.asarray(jstate["g_w"][k]))


@pytest.mark.parametrize("kw", [dict(resync=1),
                                dict(resync=2, participation="bernoulli(0.5)"),
                                dict(resync=2, metrics=True, s2w="natural")])
def test_unported_step_options_raise(kw):
    """No option of the step is left unported (resync since the rejoin
    slice): the port's step refuses exactly what the reference's does,
    resync on an identity s2w leg, with the reference's error."""
    jopt = JEF21Muon(JEF21MuonConfig(n_workers=2, use_pallas=False, **kw))
    opt = EF21Muon(EF21MuonConfig(n_workers=2, **kw))
    if kw.get("s2w", "identity") == "identity":
        with pytest.raises(ValueError) as want:
            jopt.make_step({})
        for faults in (None, object()):
            with pytest.raises(ValueError) as got:
                opt.make_step({}, faults=faults)
            assert str(got.value) == str(want.value)
    else:
        jopt.make_step({})
        opt.make_step({})
        opt.make_step({}, faults=object())
    EF21Muon(EF21MuonConfig(n_workers=2, **{**kw, "resync": 0})).make_step(
        {})


def test_radius_vector_matches_reference():
    params, metas = _tiny_tree()
    jplan = JLayerPlan.build({k: jnp.asarray(v) for k, v in params.items()},
                             {k: JParamMeta(*m) for k, m in metas.items()})
    tplan = LayerPlan.build({k: torch.from_numpy(v)
                             for k, v in params.items()},
                            {k: ParamMeta(*m) for k, m in metas.items()})
    for jb, tb in zip(jplan.ns_buckets(), tplan.ns_buckets()):
        np.testing.assert_array_equal(
            tb.radius_vector(np.float32(0.013), torch.device("cpu")).numpy(),
            np.asarray(jb.radius_vector(0.013)))
    assert math.isclose(lmo.EPS, jlmo.EPS)
