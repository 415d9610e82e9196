"""Parity of the port's packed worker->server wire with the reference's.

The narrow-index and 1-bit packing kernels' plain versions against the
reference's jnp versions and its Pallas kernels in interpret mode; the
codecs, layouts, stage plans and wire budgets; the packed buffer from
the same payloads; the packed step (staged and monolithic) against the
port's unpacked step and the reference's packed step; the Trainer over a
one-rank gloo group; and the CLI header. Everything here is integer and
byte logic, so it must agree exactly, except x after Newton-Schulz LMO
steps (``X_ATOL``, as in ``test_torch_optim.py``). The CUDA kernels are
held against the same plain versions in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _hypothesis_compat import given, settings, st
from repro.configs import get_config as jget_config
from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.core.muon import ParamMeta as JParamMeta
from repro.dist.layerwise import LayerPlan as JLayerPlan
from repro.dist.layerwise import vmap_n
from repro.kernels import bitpack as jbp
from repro.launch import train as jtrain_cli
from repro.models.api import abstract_params as jabstract_params
from repro.models.api import build_model as jbuild_model
from repro.wire.layout import build_staged_layout as jbuild_staged_layout
from repro_torch.configs import get_config
from repro_torch.core.muon import EF21Muon, EF21MuonConfig, ParamMeta
from repro_torch.dist.layerwise import LayerPlan, tree_leaves
from repro_torch.kernels import bitpack as bp
from repro_torch.launch import train as train_cli
from repro_torch.models.api import (abstract_params, build_model,
                                    params_from_jax)
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.wire.codecs import NarrowIntCodec, RawCodec
from test_torch_threads import one_torch_thread  # noqa: F401

X_ATOL = 1e-6     # x after NS-driven LMO steps (see test_torch_optim.py)
WIRE_NAMES = ["top10", "top10+natural", "natural", "identity",
              "identity+natural", "top15+natural"]


def _t(x) -> torch.Tensor:
    """A JAX/numpy array as a tensor, bit for bit (bf16 included)."""
    return params_from_jax({"a": np.asarray(x)})["a"]


# --------------------------------------------------- kernels' plain versions

def _rows_np(rows, k, hi, seed, extremes=True):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, hi, size=(rows, k), dtype=np.int64)
    if extremes:
        x.flat[0] = hi - 1
        x.flat[-1] = 0
    return x.astype(np.int32)


@settings(max_examples=8, deadline=None)
@given(width=st.sampled_from([2, 3, 4]), rows=st.integers(1, 3),
       k=st.sampled_from([1, 7, 128, 129, 300, 1031]),
       seed=st.integers(0, 2**16))
def test_narrow_encode_decode_match_reference_and_pallas(width, rows, k,
                                                         seed):
    """Row-batched narrow encode/decode == the reference's jnp version
    and its Pallas kernels (interpret) on each row, values up to
    2^(8 width) - 1 (2^31 - 1 for width 4)."""
    hi = min(1 << (8 * width), 2**31)
    idx = _rows_np(rows, k, hi, seed)
    got = bp.narrow_encode(torch.from_numpy(idx), width)
    assert got.shape == (rows, width * k) and got.dtype == torch.uint8
    for r in range(rows):
        want = np.asarray(jbp.narrow_encode_ref(jnp.asarray(idx[r]), width))
        pallas = np.asarray(jbp.narrow_encode(
            jnp.asarray(idx[r]), width, use_pallas=True, interpret=True))
        np.testing.assert_array_equal(got[r].numpy(), want)
        np.testing.assert_array_equal(pallas, want)
        back = np.asarray(jbp.narrow_decode(jnp.asarray(want), width,
                                            use_pallas=True, interpret=True))
        np.testing.assert_array_equal(back, idx[r])
    np.testing.assert_array_equal(bp.narrow_decode(got, width).numpy(), idx)


@settings(max_examples=8, deadline=None)
@given(rows=st.integers(1, 3), k=st.sampled_from([1, 5, 128, 129, 1000]),
       seed=st.integers(0, 2**16))
def test_pack_unpack_bits_match_reference_and_pallas(rows, k, seed):
    bits = np.random.default_rng(seed).integers(
        0, 2, size=(rows, 8 * k)).astype(np.uint8)
    got = bp.pack_bits(torch.from_numpy(bits))
    assert got.shape == (rows, k)
    for r in range(rows):
        want = np.asarray(jbp.pack_bits_ref(jnp.asarray(bits[r])))
        np.testing.assert_array_equal(got[r].numpy(), want)
        np.testing.assert_array_equal(np.asarray(jbp.pack_bits(
            jnp.asarray(bits[r]), use_pallas=True, interpret=True)), want)
        np.testing.assert_array_equal(np.asarray(jbp.unpack_bits(
            jnp.asarray(want), use_pallas=True, interpret=True)), bits[r])
        np.testing.assert_array_equal(
            np.asarray(jbp.unpack_bits_ref(jnp.asarray(want))), bits[r])
    np.testing.assert_array_equal(bp.unpack_bits(got).numpy(), bits)


def test_narrow_width_and_argument_checks():
    for dom in (1, 2**16, 2**16 + 1, 2**24, 2**24 + 1, 38_633_472):
        assert bp.narrow_width(dom) == jbp.narrow_width(dom)
    with pytest.raises(ValueError, match="width"):
        bp.narrow_encode(torch.zeros(4, dtype=torch.int32), 5)
    # a 12-byte row packs to 2 bytes: the reference's pack of the row
    # padded with zeros to whole bytes
    row = np.random.default_rng(12).integers(0, 2, size=12).astype(np.uint8)
    got = bp.pack_bits(torch.from_numpy(row))
    assert got.shape == (2,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbp.pack_bits_ref(
        jnp.pad(jnp.asarray(row), (0, 4)))))
    with pytest.raises(ValueError, match="multiple of width"):
        bp.narrow_decode(torch.zeros(10, dtype=torch.uint8), 3)


@pytest.mark.parametrize("d_ff,width", [(8192, 3), (11008, 4)])
def test_narrow_width_at_full_width_mlp_slices(d_ff, width):
    """The u24/raw boundary at the dense family's MLP slices [2048, d_ff]:
    granite-3-2b's 2048 x 8192 is exactly 2^24 entries, the last domain
    three bytes index; qwen2.5-3b's 2048 x 11008 needs four (raw int32),
    as in the reference."""
    domain = 2048 * d_ff
    assert bp.narrow_width(domain) == jbp.narrow_width(domain) == width
    assert bp.narrow_width(domain + 1) == jbp.narrow_width(domain + 1)


# ------------------------------------------------------------------ codecs

@pytest.mark.parametrize("codec,dtype", [
    (RawCodec((5, 3), torch.bfloat16), jnp.bfloat16),
    (RawCodec((7,), torch.float32), jnp.float32),
    (RawCodec((9,), torch.uint8), jnp.uint8),
    (RawCodec((4,), torch.int32), jnp.int32),
    (NarrowIntCodec((11,), 2), jnp.int32),
    (NarrowIntCodec((13,), 3), jnp.int32)])
def test_codec_rows_equal_reference_codec_per_slice(codec, dtype):
    from repro.wire import codecs as jcodecs
    rows = 3
    rng = np.random.default_rng(5)
    if isinstance(codec, NarrowIntCodec):
        x = jnp.asarray(rng.integers(0, 1 << (8 * codec.width),
                                     size=(rows,) + codec.shape),
                        jnp.int32)
        jc = jcodecs.NarrowIntCodec(codec.shape, codec.width)
    else:
        x = jnp.asarray(rng.standard_normal((rows,) + codec.shape) * 50
                        ).astype(dtype)
        jc = jcodecs.RawCodec(codec.shape, jnp.dtype(dtype).name)
    got = codec.pack(_t(x))
    assert got.shape == (rows, codec.nbytes) and codec.cid == jc.cid
    for r in range(rows):
        np.testing.assert_array_equal(got[r].numpy(),
                                      np.asarray(jc.pack(x[r])))
    # unpack from an unaligned, non-contiguous slice of a wider buffer
    wide = torch.cat([torch.zeros(rows, 1, dtype=torch.uint8), got], 1)
    back = codec.unpack(wide[:, 1:])
    assert back.dtype == _t(x).dtype
    assert torch.equal(back, _t(x))


# ------------------------------------------------- layouts and stage plans

def _plans(w2s, reduced=True):
    jcfg, cfg = jget_config("nanogpt-124m"), get_config("nanogpt-124m")
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jshapes, jmetas = jabstract_params(jbuild_model(jcfg))
    shapes, metas = abstract_params(build_model(cfg))
    return (JLayerPlan.build(jshapes, jmetas, w2s=w2s),
            LayerPlan.build(shapes, metas, w2s=w2s))


def _stage_fields(sp):
    return [(s.leaf_ids, s.bucket_ids, s.ns_flops) for s in sp.stages]


@pytest.mark.parametrize("w2s", WIRE_NAMES)
def test_reduced_nanogpt_layout_and_stages_equal_reference(w2s):
    jplan, plan = _plans(w2s)
    assert plan.wire_layout(torch.bfloat16).describe() == \
        jplan.wire_layout(jnp.bfloat16).describe()
    for ws in ("auto", 1, 2):
        jsp, sp = jplan.stage_plan(wire_stages=ws), plan.stage_plan(ws)
        assert _stage_fields(sp) == _stage_fields(jsp)
        assert sp.eager_leaf_ids == jsp.eager_leaf_ids
        sw = plan.staged_wire_layout(torch.bfloat16, sp)
        jsw = jplan.staged_wire_layout(jnp.bfloat16, jsp)
        assert [st_.describe() for st_ in sw.stages] == \
            [st_.describe() for st_ in jsw.stages]


@pytest.mark.parametrize("w2s,total,stages", [
    ("top10", 66_194_428, (23_726_908, 28_311_600, 14_155_920)),
    ("top10+natural", 55_313_394, (20_277_666, 23_357_088, 11_678_640)),
    ("natural", 140_052_480, (44_500_992, 63_700_992, 31_850_496))])
def test_full_nanogpt_wire_bytes_on_meta_tensors(w2s, total, stages):
    """Full-width nanogpt-124m, built on meta tensors: 14 leaves, 3
    stages (8 eager leaves, the [24,768,3072] bucket, the [48,768,768]
    bucket); wte's indices stay raw int32 (domain > 2^24)."""
    _, plan = _plans(w2s, reduced=False)
    layout = plan.wire_layout(torch.bfloat16)
    assert layout.total_nbytes == total
    sw = plan.staged_wire_layout(torch.bfloat16, plan.stage_plan())
    assert tuple(sw.stage_nbytes(k) for k in range(sw.n_stages)) == stages
    codecs = [d["codec"] for d in layout.describe()]
    if w2s.startswith("top10"):
        assert sum("u24" in c for c in codecs) == 7
        assert sum("raw:int32" in c for c in codecs) == 1
        assert sum(c == "identity[raw:float32]" for c in codecs) == 6
    if w2s == "top10+natural":   # k = 58,983 on a 768^2 slice
        assert layout.describe()[0]["slice_nbytes"] == 243_305


@pytest.mark.parametrize("w2s", ["top10", "top10+natural"])
def test_full_nanogpt_layout_equals_reference(w2s):
    jplan, plan = _plans(w2s, reduced=False)
    assert plan.wire_layout(torch.bfloat16).describe() == \
        jplan.wire_layout(jnp.bfloat16).describe()


@pytest.mark.parametrize("kw", [dict(), dict(wire_stages=1),
                                dict(wire_stages=2), dict(wire_pack=False),
                                dict(ns_bucketing=False)])
@pytest.mark.parametrize("distributed", [True, False])
def test_wire_budget_equals_reference(kw, distributed):
    jshapes, jmetas = jabstract_params(jbuild_model(
        jget_config("nanogpt-124m").reduced()))
    shapes, metas = abstract_params(build_model(
        get_config("nanogpt-124m").reduced()))
    jb = JEF21Muon(JEF21MuonConfig(n_workers=2, w2s="top10", **kw)
                   ).wire_budget(jshapes, jmetas, distributed=distributed)
    opt = EF21Muon(EF21MuonConfig(n_workers=2, w2s="top10", **kw))
    b = opt.wire_budget(shapes, metas, distributed=distributed)
    assert (b.pack_w2s, b.pack_s2w, b.n_stages, b.w2s_sizes, b.s2w_sizes,
            b.n_workers, b.two_way_nbytes) == \
        (jb.pack_w2s, jb.pack_s2w, jb.n_stages, jb.w2s_sizes, jb.s2w_sizes,
         jb.n_workers, jb.two_way_nbytes)
    assert opt.wire_bytes_per_worker(shapes, metas) == \
        JEF21Muon(JEF21MuonConfig(w2s="top10")).wire_bytes_per_worker(
            jshapes, jmetas)


# ------------------------------------------------ packed bytes, same payloads

def _payloads(jplan, n_workers, seed):
    """Reference payloads of random messages, per leaf with
    [n_workers, *stack] leading dims (as phase 3 makes them)."""
    rng = np.random.default_rng(seed)
    out = []
    for lp in jplan.leaves:
        lossless = getattr(lp.w2s, "lossless_wire", False)
        x = jnp.asarray(rng.standard_normal((n_workers,) + lp.shape),
                        jnp.float32)
        x = x if lossless else x.astype(jnp.bfloat16)
        out.append(vmap_n(lambda s, c=lp.w2s: c.compress({}, s)[0],
                          lp.meta.stack_dims + 1)(x))
    return out


def _payload_to_torch(pl):
    if isinstance(pl, dict):
        return {k: _t(v) for k, v in pl.items()}
    return _t(pl)


def _assert_payload_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("w2s", WIRE_NAMES[:-1])
def test_packed_buffer_byte_equal_to_reference(w2s):
    """From the same payloads, the port's monolithic and staged buffers
    equal the reference's byte for byte, and unpack gives the payloads
    back bit for bit."""
    jplan, plan = _plans(w2s)
    jpls = _payloads(jplan, 2, 3)
    pls = [_payload_to_torch(p) for p in jpls]
    jlayout, layout = (jplan.wire_layout(jnp.bfloat16),
                       plan.wire_layout(torch.bfloat16))
    buf = layout.pack(pls)
    assert buf.shape == (2, layout.total_nbytes)
    np.testing.assert_array_equal(buf.numpy(),
                                  np.asarray(jlayout.pack(jpls)))
    for got, want in zip(layout.unpack(buf), pls):
        _assert_payload_equal(got, want)
    jsw = jbuild_staged_layout(
        jlayout, [s.leaf_ids for s in jplan.stage_plan().stages])
    sw = plan.staged_wire_layout(torch.bfloat16, plan.stage_plan())
    for k in range(sw.n_stages):
        sbuf = sw.pack_stage(k, pls)
        np.testing.assert_array_equal(sbuf.numpy(),
                                      np.asarray(jsw.pack_stage(k, jpls)))
        for i, got in zip(sw.stage_leaf_ids[k], sw.unpack_stage(k, sbuf)):
            _assert_payload_equal(got, pls[i])


# ------------------------------------------------------------ the step

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


def _run_tiny(w2s, steps, hooks, jax_too=False, **kw):
    """The port's step on the tiny tree, once per hook in ``hooks``
    (None = unpacked), from the same state on the same handed-in
    gradients; with ``jax_too`` also the reference's packed step."""
    params, metas = _tiny_tree()
    cfg = dict(n_workers=2, beta=0.5, w2s=w2s, **kw)
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    grads = [{k: np.random.default_rng(100 + 7 * s + i).standard_normal(
        (2,) + v.shape).astype(np.float32)
        for i, (k, v) in enumerate(params.items())} for s in range(steps)]

    def grad_fn(params, batch):
        return sum(torch.sum(p) for p in params.values()), dict(batch)

    states = []
    for hook in hooks:
        opt = EF21Muon(EF21MuonConfig(**cfg))
        state = opt.init(None, {k: torch.from_numpy(v)
                                for k, v in params.items()}, tmetas)
        step = opt.make_step(tmetas, reshard_payloads=hook)
        for s in range(steps):
            state, _ = step(state, grad_fn, {k: torch.from_numpy(g) for k, g
                                             in grads[s].items()},
                            0.02 * (s + 1))
        states.append(state)
    if jax_too:
        jopt = JEF21Muon(JEF21MuonConfig(use_pallas=False, **cfg))
        jmetas = {k: JParamMeta(*m) for k, m in metas.items()}
        jstate = jopt.init(jax.random.key(0), {k: jnp.asarray(v) for k, v
                                               in params.items()}, jmetas)
        step = jopt.make_step(jmetas, reshard_payloads=lambda t: t)
        jstep = jax.jit(lambda st, b, t: step(st, lambda p, b_: (
            sum(jnp.sum(v) for v in p.values()), dict(b_)), b, t))
        for s in range(steps):
            jstate, _ = jstep(jstate, {k: jnp.asarray(g) for k, g
                                       in grads[s].items()},
                              jnp.float32(0.02 * (s + 1)))
        states.append(jstate)
    return states


def _assert_states_equal(a, b):
    for key in ("x", "g_server", "g_w", "m_w"):
        for u, v in zip(tree_leaves(a[key]), tree_leaves(b[key])):
            assert torch.equal(u, v), key


@pytest.mark.parametrize("w2s", ["top10", "top10+natural", "natural"])
@pytest.mark.parametrize("wire_stages", ["auto", 1])
def test_packed_step_bit_equal_to_unpacked(w2s, wire_stages):
    """Staged and monolithic packed steps leave exactly the unpacked
    step's state (pack -> unpack is bit-exact); the hook sees one buffer
    per stage per step."""
    seen = []

    def hook(buf):
        assert buf.dtype == torch.uint8 and buf.shape[0] == 2
        seen.append(buf.shape[1])
        return buf.clone()

    unpacked, packed = _run_tiny(w2s, 3, [None, hook],
                                 wire_stages=wire_stages)
    _assert_states_equal(packed, unpacked)
    assert len(seen) == 3 * (3 if wire_stages == "auto" else 1)


@pytest.mark.parametrize("w2s", ["top10", "top10+natural"])
@pytest.mark.parametrize("wire_stages", ["auto", 1])
def test_packed_step_matches_reference_packed_step(w2s, wire_stages):
    """Against the reference's packed step (``reshard_payloads=lambda t:
    t``): EF21 state bit-equal, x within X_ATOL, after 2 steps."""
    tstate, jstate = _run_tiny(w2s, 2, [lambda t: t], jax_too=True,
                               wire_stages=wire_stages)
    for key in ("g_w", "m_w", "g_server"):
        for k in jstate[key]:
            np.testing.assert_array_equal(tstate[key][k].numpy(),
                                          np.asarray(jstate[key][k]),
                                          err_msg=f"{key}/{k}")
    for k in jstate["x"]:
        np.testing.assert_allclose(tstate["x"][k].numpy(),
                                   np.asarray(jstate["x"][k]), rtol=0,
                                   atol=X_ATOL, err_msg=f"x/{k}")


def test_unpacked_hook_gets_the_payloads():
    """wire_pack=False with a hook: the hook gets the per-leaf payload
    list, as in the reference, and the step is unchanged."""
    seen = []

    def hook(payloads):
        seen.append(len(payloads))
        return payloads

    unpacked, hooked = _run_tiny("top10", 2, [None, hook], wire_pack=False)
    _assert_states_equal(hooked, unpacked)
    assert seen == [6, 6]


# ----------------------------------------------------- trainer and CLI

@pytest.fixture(scope="module")
def gloo_group():
    from torch.distributed import HashStore
    dist.init_process_group("gloo", store=HashStore(), rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("w2s,wire_stages", [("top10", "auto"),
                                             ("top10+natural", "auto"),
                                             ("top10", 1)])
def test_trainer_over_one_rank_gloo_group(gloo_group, w2s, wire_stages):
    """Reduced nanogpt, 2 workers, 2 steps: the hook's all-gathers are
    n_workers x the wire budget's sizes, every step; the losses equal
    the group-less trainer's."""
    args = train_cli.parse_args(["--arch", "nanogpt-124m", "--reduced",
                                 "--seq", "16", "--batch", "2", "--workers",
                                 "2", "--w2s", w2s, "--device", "cpu"])
    cfg, _, data, sched = train_cli.setup(args)
    runs = []
    for group in (None, gloo_group):
        tr = Trainer(build_model(cfg), TrainerConfig(
            n_workers=2, beta=args.beta, w2s=w2s, wire_stages=wire_stages),
            device="cpu", group=group)
        out = train_cli.run_steps(tr, tr.init(0), data, sched, 2)
        runs.append((tr, out["losses"]))
    (tr0, l0), (tr, l1) = runs
    assert l1 == l0 and tr0.gathered == []
    budget = tr.wire_budget()
    assert budget.pack_w2s and len(budget.w2s_sizes) == budget.n_stages \
        == (3 if wire_stages == "auto" else 1)
    assert tr.gathered == [2 * s for s in budget.w2s_sizes] * 2
    assert sum(tr.gathered) == 2 * 2 * tr.layer_plan().wire_layout(
        torch.bfloat16).total_nbytes


@pytest.mark.parametrize("n_workers", [1, 3])
def test_trainer_refuses_a_group_that_does_not_divide_the_workers(
        n_workers):
    """Each rank owns whole workers: a group of 2 ranks takes an even
    number of workers, and refuses 1 or 3 before it asks for a rank."""
    class TwoRanks:
        def size(self):
            return 2

    with pytest.raises(ValueError, match="must divide n_workers"):
        Trainer(build_model(get_config("nanogpt-124m").reduced()),
                TrainerConfig(n_workers=n_workers), device="cpu",
                group=TwoRanks())


@pytest.mark.parametrize("w2s", ["top10", "top10+natural", "natural"])
def test_cli_header_equals_reference_field_for_field(w2s, capsys,
                                                     monkeypatch):
    argv = ["--arch", "nanogpt-124m", "--reduced", "--steps", "0", "--seq",
            "16", "--batch", "2", "--workers", "2", "--w2s", w2s]
    train_cli.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()[0].split()
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain_cli.main()
    theirs = capsys.readouterr().out.splitlines()[0].split()
    assert ours[-1] == "device=cpu"
    assert ours[:-1] == theirs
