"""The port's placement rules against the reference's.

``repro_torch.dist.sharding`` ports the reference's rules as pure
functions over a shape-only mesh. For every arch of the registry, full
and reduced, with shapes taken from abstract params on both sides (meta
tensors and ``jax.eval_shape``: nothing is allocated), and at the
stand-in meshes ``{data: 2}``, ``{data: 4, model: 2}`` and ``{pod: 2,
data: 2, model: 2}``, the port's ``param_pspec`` (with and without
``fsdp``), ``_zero1_pspec``, ``state_pspecs``, ``serve_pspecs`` (with
``cache_alt``), ``batch_pspec`` and ``build_buckets(plan, mesh, fsdp)``
give the reference's specs and buckets entry for entry. A hypothesis
property holds ``ns_bucket_pspec`` to the reference's on random meshes
and buckets. No process is spawned.
"""
from __future__ import annotations

import functools

import jax
import pytest
from _hypothesis_compat import given, settings, st

from repro.configs import get_config as jget_config
from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.dist import sharding as jsharding
from repro.dist.bucketing import build_buckets as jbuild_buckets
from repro.dist.layerwise import LayerPlan as JLayerPlan
from repro.models.api import abstract_params as jabstract_params
from repro.models.api import build_model as jbuild_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.muon import EF21Muon, EF21MuonConfig
from repro_torch.dist import sharding
from repro_torch.dist.bucketing import build_buckets
from repro_torch.dist.layerwise import LayerPlan, leaf_paths, tree_get
from repro_torch.models.api import abstract_params, build_model

MESHES = {
    "data2": dict(data=2),
    "data4_model2": dict(data=4, model=2),
    "pod2_data2_model2": dict(pod=2, data=2, model=2),
}
CASES = [(a, r) for a in ARCHS for r in (False, True)]
IDS = [f"{a}{'-reduced' if r else ''}" for a, r in CASES]
N_WORKERS = 4
SERVE_BATCH, SERVE_LEN = 4, 64


class FakeMesh:
    """The reference's shape-only stand-in (``tests/test_sharding.py``)."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def _meshes(name):
    return FakeMesh(**MESHES[name]), sharding.MeshShape(**MESHES[name])


@functools.lru_cache(maxsize=None)
def _both(arch: str, reduced: bool):
    """(reference model, its abstract params and metas; the port's)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jp, jm = jabstract_params(jmodel)
    p, m = abstract_params(model)
    return jmodel, jp, jm, model, p, m


def _spec(s):
    """A reference spec as the port's: a tuple, an axis tuple kept."""
    return tuple(tuple(a) if isinstance(a, (list, tuple)) else a for a in s)


def _flat(tree, prefix=()):
    """Path -> leaf of nested dicts (a spec tuple is a leaf; None and
    empty dicts leave nothing)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if tree is None:
        return {}
    return {prefix: tree}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,reduced", CASES, ids=IDS)
def test_param_specs_are_the_references(arch, reduced, mesh_name):
    """``param_pspec`` with and without ``fsdp``, ``_zero1_pspec`` with
    and without it, and ``_worker_pspec``, leaf for leaf; ``param_pspecs``
    over the tree."""
    _, jp, jm, _, p, m = _both(arch, reduced)
    jmesh, mesh = _meshes(mesh_name)
    paths = leaf_paths(p)
    assert paths == leaf_paths(jp)
    for fsdp in (False, True):
        specs = sharding.param_pspecs(p, m, mesh, fsdp=fsdp)
        jspecs = jsharding.param_pspecs(jp, jm, jmesh, fsdp=fsdp)
        for path in paths:
            shape = tuple(tree_get(p, path).shape)
            meta, jmeta = tree_get(m, path), tree_get(jm, path)
            want = _spec(tree_get(jspecs, path))
            assert tree_get(specs, path) == want, (path, fsdp)
            assert sharding.param_pspec(meta, shape, mesh, fsdp) == want
            assert sharding._zero1_pspec(meta, shape, mesh, fsdp) == _spec(
                jsharding._zero1_pspec(jmeta, shape, jmesh, fsdp)), path
            wshape = (N_WORKERS,) + shape
            assert sharding._worker_pspec(meta, wshape, mesh, fsdp) \
                == _spec(jsharding._worker_pspec(jmeta, wshape, jmesh,
                                                 fsdp)), path


@functools.lru_cache(maxsize=None)
def _states(arch: str, reduced: bool):
    """Both packages' abstract EF21-Muon states: 4 workers, top10 /
    natural (``w``), and the resync's ``w_w`` and ring where the ring's
    row fits the reference's bound (the reduced configs)."""
    _, jp, jm, _, p, m = _both(arch, reduced)
    kw = dict(n_workers=N_WORKERS, w2s="top10", s2w="natural",
              resync=2 if reduced else None)
    jopt = JEF21Muon(JEF21MuonConfig(**kw))
    jst = jax.eval_shape(lambda k, q: jopt.init(k, q, jm),
                         jax.random.key(0), jp)
    st = EF21Muon(EF21MuonConfig(**kw)).init(None, p, m)
    return jst, st


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,reduced", CASES, ids=IDS)
def test_state_specs_are_the_references(arch, reduced, mesh_name):
    """``state_pspecs`` under each of the four (fsdp, zero1_lmo) pairs:
    the server's, the worker-lead and the replicated leaves alike."""
    _, jp, jm, _, p, m = _both(arch, reduced)
    jmesh, mesh = _meshes(mesh_name)
    jst, st = _states(arch, reduced)
    for fsdp in (False, True):
        for zero1 in (False, True):
            got = sharding.state_pspecs(st, p, m, mesh, fsdp=fsdp,
                                        zero1_lmo=zero1)
            want = jsharding.state_pspecs(jst, jp, jm, jmesh, fsdp=fsdp,
                                          zero1_lmo=zero1)
            assert set(got) == set(want)
            for key in ("x", "g_server", "w", "g_w", "m_w", "w_w", "step",
                        "resync"):
                if key not in want:
                    assert key not in got
                    continue
                g, w = _flat(got[key]), _flat(want[key])
                if key == "step":
                    g, w = {(): got[key]}, {(): want[key]}
                assert sorted(g) == sorted(w), key
                for path in w:
                    assert g[path] == _spec(w[path]), (key, path, fsdp,
                                                       zero1)
            # the compressor states (per leaf in the port, trees like the
            # params in the reference) are replicated on both sides
            for key in ("cw_state", "cs_state"):
                for leaf in jax.tree.leaves(want[key]):
                    assert all(a is None for a in leaf)
                for spec in jax.tree.leaves(
                        got[key], is_leaf=lambda s: isinstance(s, tuple)):
                    assert all(a is None for a in spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,reduced", CASES, ids=IDS)
def test_serve_and_batch_specs_are_the_references(arch, reduced,
                                                  mesh_name):
    """``serve_pspecs`` of the decode cache (the batch dim found through
    ``cache_alt``, and by size without it), and ``batch_pspec``'s train
    and prefill rules on a batch of each kind."""
    jmodel, _, _, model, _, _ = _both(arch, reduced)
    jmesh, mesh = _meshes(mesh_name)
    jc = jmodel.cache_spec(SERVE_BATCH, SERVE_LEN)
    jalt = jmodel.cache_spec(SERVE_BATCH + 1, SERVE_LEN)
    c = model.cache_spec(SERVE_BATCH, SERVE_LEN)
    alt = model.cache_spec(SERVE_BATCH + 1, SERVE_LEN)
    for got, want in (
            (sharding.serve_pspecs(c, SERVE_BATCH, mesh, cache_alt=alt),
             jsharding.serve_pspecs(jc, SERVE_BATCH, jmesh, cache_alt=jalt)),
            (sharding.serve_pspecs(c, SERVE_BATCH, mesh),
             jsharding.serve_pspecs(jc, SERVE_BATCH, jmesh))):
        g, w = _flat(got), _flat(want)
        assert sorted(g) == sorted(w)
        for path in w:
            assert g[path] == _spec(w[path]), path

    class S:
        def __init__(self, shape):
            self.shape = shape

    batch = {"tokens": S((N_WORKERS, 8, 32)), "labels": S((N_WORKERS, 8,
                                                            32))}
    for kind in ("train", "prefill", "decode"):
        assert sharding.batch_pspec(batch, mesh, kind) == {
            k: _spec(v) for k, v in
            jsharding.batch_pspec(batch, jmesh, kind).items()}


def _buckets_equal(got, want) -> None:
    assert len(got) == len(want)
    for b, jb in zip(got, want):
        assert (b.shape, b.leaf_ids, b.leaf_shapes, b.transposes, b.counts,
                b.radius_scales) == (tuple(jb.shape), jb.leaf_ids,
                                     tuple(tuple(s) for s in jb.leaf_shapes),
                                     jb.transposes, jb.counts,
                                     jb.radius_scales)
        assert b.pspec == (None if jb.pspec is None else _spec(jb.pspec))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,reduced", CASES, ids=IDS)
def test_buckets_are_the_references(arch, reduced, mesh_name):
    """``build_buckets(plan, mesh, fsdp)``: membership, order, the
    orientation sub-split and every bucket's spec; without a mesh the
    buckets are the mesh-less ones, and over ``{data: P}`` alone the
    membership and order are too."""
    _, jp, jm, _, p, m = _both(arch, reduced)
    jmesh, mesh = _meshes(mesh_name)
    plan, jplan = LayerPlan.build(p, m), JLayerPlan.build(jp, jm)
    for fsdp in (False, True):
        _buckets_equal(build_buckets(plan, mesh, fsdp),
                       jbuild_buckets(jplan, jmesh, fsdp))
        _buckets_equal(plan.ns_buckets(mesh=mesh, fsdp=fsdp),
                       jplan.ns_buckets(mesh=jmesh, fsdp=fsdp))
    _buckets_equal(build_buckets(plan), jbuild_buckets(jplan))
    if "model" not in MESHES[mesh_name]:
        strip = lambda bs: [(b.shape, b.leaf_ids) for b in bs]  # noqa: E731
        assert strip(build_buckets(plan, mesh)) == strip(build_buckets(plan))
        assert plan.stage_plan(mesh=mesh) == plan.stage_plan()


@given(data_n=st.integers(1, 8), model_n=st.integers(1, 8),
       pod_n=st.integers(1, 4), batch=st.integers(1, 96),
       m=st.sampled_from([8, 48, 64, 96]), n=st.sampled_from([64, 96, 256]),
       members=st.lists(st.sampled_from(
           [(None, "model"), ("model", None), (None, None),
            ("data", "model"), (None, "data")]), min_size=1, max_size=5),
       stack_model=st.booleans())
@settings(max_examples=120, deadline=None)
def test_ns_bucket_pspec_property(data_n, model_n, pod_n, batch, m, n,
                                  members, stack_model):
    """The mesh-shape x bucket-shape sweep of ``tests/test_sharding.py``:
    the port's spec is the reference's, no axis is used twice, and the
    batch dim shards only where its composition divides it."""
    axes = {}
    if pod_n > 1:
        axes["pod"] = pod_n
    axes["data"] = data_n
    axes["model"] = model_n
    if m > n:
        m, n = n, m
    got = sharding.ns_bucket_pspec(batch, (m, n), members,
                                   sharding.MeshShape(**axes),
                                   stack_model=stack_model)
    want = jsharding.ns_bucket_pspec(batch, (m, n), members,
                                     FakeMesh(**axes),
                                     stack_model=stack_model)
    assert got == _spec(want)
    flat = [a for e in got if e is not None
            for a in ((e,) if isinstance(e, str) else e)]
    assert len(flat) == len(set(flat))
    lead = got[0]
    if lead is not None:
        size = 1
        for a in ((lead,) if isinstance(lead, str) else lead):
            size *= axes[a]
        assert batch % size == 0 and size > 1


def test_a_group_is_the_data_axis():
    """``mesh_for`` of a group of P ranks is ``{data: P}``, the worker
    axis ``worker_axis_for`` names for one pod; no group, no mesh."""

    class Group:
        def size(self):
            return 3

    mesh = sharding.mesh_for(Group())
    assert mesh.shape == {"data": 3} and mesh.axis_names == ("data",)
    assert sharding.worker_axis_for(mesh) == "data"
    assert jsharding.worker_axis_for(mesh) == "data"
    assert sharding.mesh_for(None) is None
    assert sharding.data_dim((None, "data", None)) == 1
    assert sharding.data_dim((None, None)) is None
    with pytest.raises(ValueError, match="other than"):
        sharding.data_dim(("model", None))


def test_split_rows_follows_the_bucket_spec():
    """A bucket's rows are split only where its spec puts the batch dim on
    the group's axis and P > 1 ranks divide it; a spec over another axis
    raises (a group is the worker axis only)."""
    from repro_torch.kernels.ops import split_rows

    class Group:
        def size(self):
            return 2

    assert split_rows(8, None, ("data", None, None)) is None
    assert split_rows(8, Group(), None) is None
    assert split_rows(8, Group(), (None, None, "model")) is None
    assert split_rows(7, Group(), ("data", None, None)) is None
    for spec in (("model", None, None), (("pod", "data"), None, None)):
        with pytest.raises(ValueError, match="'data' axis only"):
            split_rows(8, Group(), spec)
