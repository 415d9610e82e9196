"""The packed wire writes each stage buffer once and reads it in place.

``WireLayout.pack`` allocates the ``[n_workers, total_nbytes]`` buffer and
every codec writes its column of each leaf's region, ``[n_workers,
n_stack, nbytes]`` (a view), with no concatenation; ``unpack`` hands the
codecs the same views, and the uint8 leaves come back as views of the
buffer. Here, on the CPU (plain versions of the kernels): the narrow
encode into strided ``out=`` views against the reference's
``narrow_encode_ref``, the packed buffers of reduced nanogpt against the
reference's byte for byte with ``torch.cat`` unavailable, and the unpacked
payloads' storage. ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
hold the card's kernels to the same views.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.dist.layerwise import LayerPlan as JLayerPlan
from repro.dist.layerwise import vmap_n
from repro.kernels import bitpack as jbp
from repro.models.api import abstract_params as jabstract_params
from repro.models.api import build_model as jbuild_model
from repro.wire.layout import build_staged_layout as jbuild_staged_layout
from repro_torch.configs import get_config
from repro_torch.dist.layerwise import LayerPlan
from repro_torch.kernels import bitpack as bp
from repro_torch.models.api import (abstract_params, build_model,
                                    params_from_jax)
from repro_torch.wire import codecs
from repro_torch.wire.codecs import NarrowIntCodec, flatten_payload
from test_torch_threads import one_torch_thread  # noqa: F401

WIRE_NAMES = ["top10", "top10+natural"]


def _t(x) -> torch.Tensor:
    return params_from_jax({"a": np.asarray(x)})["a"]


def _indices(shape, width, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << (8 * width) if width < 4 else 2**31,
                     size=shape, dtype=np.int64).astype(np.int32)
    x.reshape(-1)[0] = (1 << (8 * width)) - 1 if width < 4 else 2**31 - 1
    return x


@pytest.mark.parametrize("k", [1, 7, 129, 1003])
@pytest.mark.parametrize("width", [2, 3, 4])
@pytest.mark.parametrize("offset", [0, 1, 3, 5])
def test_narrow_encode_into_a_region_column_equals_reference(offset, width,
                                                            k):
    """Indices ``[2, 3, k]`` encoded into the column at byte ``offset`` of
    a ``[2, 3, S]`` region of a ``[2, T]`` buffer (odd S and T): each row
    equals the reference's encode of it, and no byte outside the column
    changes."""
    n, n_stack = width * k, 3
    s_slice = offset + n + 3
    total = n_stack * s_slice + 5
    buf = torch.from_numpy(np.random.default_rng(k).integers(
        0, 256, size=(2, total), dtype=np.uint8))
    before = buf.clone()
    col = buf[:, :n_stack * s_slice].unflatten(1, (n_stack, s_slice))[
        :, :, offset:offset + n]
    assert bp._row_strides(col, "narrow_encode") == (2, n_stack, total,
                                                     s_slice)
    idx = _indices((2, n_stack, k), width, seed=offset + width + k)
    assert bp.narrow_encode(torch.from_numpy(idx), width, out=col) is col
    mask = torch.ones_like(buf, dtype=torch.bool)
    mask[:, :n_stack * s_slice].unflatten(1, (n_stack, s_slice))[
        :, :, offset:offset + n] = False
    assert torch.equal(buf[mask], before[mask])
    for w in range(2):
        for j in range(n_stack):
            want = np.asarray(jbp.narrow_encode_ref(jnp.asarray(idx[w, j]),
                                                    width))
            np.testing.assert_array_equal(col[w, j].numpy(), want)
    np.testing.assert_array_equal(bp.narrow_decode(col, width).numpy(), idx)


def test_narrow_encode_out_is_checked():
    idx = torch.zeros((2, 5), dtype=torch.int32)
    for out in (torch.empty((2, 14), dtype=torch.uint8),     # wrong width
                torch.empty((3, 15), dtype=torch.uint8),     # wrong rows
                torch.empty((2, 15), dtype=torch.int32)):    # wrong dtype
        with pytest.raises(ValueError, match="narrow_encode out"):
            bp.narrow_encode(idx, 3, out=out)


def _plans(w2s):
    jcfg = jget_config("nanogpt-124m").reduced()
    cfg = get_config("nanogpt-124m").reduced()
    return (JLayerPlan.build(*jabstract_params(jbuild_model(jcfg)), w2s=w2s),
            LayerPlan.build(*abstract_params(build_model(cfg)), w2s=w2s))


def _payloads(jplan, n_workers, seed):
    """Reference payloads of random messages (bf16, f32 for a lossless
    compressor), per leaf with ``[n_workers, *stack]`` leading dims, as
    phase 3 makes them."""
    rng = np.random.default_rng(seed)
    out = []
    for lp in jplan.leaves:
        x = jnp.asarray(rng.standard_normal((n_workers,) + lp.shape),
                        jnp.float32)
        if not getattr(lp.w2s, "lossless_wire", False):
            x = x.astype(jnp.bfloat16)
        out.append(vmap_n(lambda s, c=lp.w2s: c.compress({}, s)[0],
                          lp.meta.stack_dims + 1)(x))
    return out


def _to_torch(pl):
    names, leaves = flatten_payload(pl)
    return codecs.unflatten_payload(names, [_t(x) for x in leaves])


def _no_cat(*args, **kwargs):
    raise AssertionError("torch.cat called on the wire's pack/unpack path")


@pytest.mark.parametrize("w2s", WIRE_NAMES)
def test_stage_buffers_written_in_place_equal_reference(w2s, monkeypatch):
    """Monolithic and staged buffers equal the reference's byte for byte,
    packed and unpacked with ``torch.cat`` unavailable; every narrow leaf
    is encoded straight into its column of the buffer."""
    jplan, plan = _plans(w2s)
    jpls = _payloads(jplan, 2, 11)
    pls = [_to_torch(p) for p in jpls]
    jlayout = jplan.wire_layout(jnp.bfloat16)
    layout = plan.wire_layout(torch.bfloat16)
    jsw = jbuild_staged_layout(
        jlayout, [s.leaf_ids for s in jplan.stage_plan().stages])
    sw = plan.staged_wire_layout(torch.bfloat16, plan.stage_plan())
    wants = [np.asarray(jlayout.pack(jpls))] + [
        np.asarray(jsw.pack_stage(k, jpls)) for k in range(sw.n_stages)]

    seen = []
    real = codecs.narrow_encode

    def recording(idx, width, out=None):
        seen.append(out)
        return real(idx, width, out=out)

    monkeypatch.setattr(codecs, "narrow_encode", recording)
    monkeypatch.setattr(torch, "cat", _no_cat)
    packs = [(layout, lambda: layout.pack(pls), layout.unpack)] + [
        (sw.stages[k], lambda k=k: sw.pack_stage(k, pls),
         lambda b, k=k: sw.unpack_stage(k, b)) for k in range(sw.n_stages)]
    n_narrow = 0
    for (lay, pack, unpack), want in zip(packs, wants, strict=True):
        seen.clear()
        buf = pack()
        assert buf.is_contiguous() and buf.shape == (2, lay.total_nbytes)
        np.testing.assert_array_equal(buf.numpy(), want)
        assert seen and all(
            o.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
            for o in seen)
        n_narrow += len(seen)
        unpack(buf)
    n_leaves = sum(isinstance(c, NarrowIntCodec)
                   for s in layout.specs for c in s.codecs)
    assert n_narrow == 2 * n_leaves     # once monolithic, once staged


@pytest.mark.parametrize("w2s", WIRE_NAMES)
def test_unpack_reads_multi_leaf_stages_in_place(w2s, monkeypatch):
    """Every stage's payloads come back bit for bit; its uint8 leaves
    (Natural's codes and sign bitmaps) are views of the stage buffer at
    their column, and the narrow decode reads its column of the buffer
    itself: no leaf's region is copied."""
    jplan, plan = _plans(w2s)
    pls = [_to_torch(p) for p in _payloads(jplan, 2, 5)]
    sw = plan.staged_wire_layout(torch.bfloat16, plan.stage_plan())
    seen = []
    real = codecs.narrow_decode

    def recording(b, width):
        seen.append(b)
        return real(b, width)

    monkeypatch.setattr(codecs, "narrow_decode", recording)
    n_u8 = 0
    assert any(len(ids) > 1 for ids in sw.stage_leaf_ids)
    for k, stage in enumerate(sw.stages):
        buf = sw.pack_stage(k, pls)
        ptr = buf.untyped_storage().data_ptr()
        seen.clear()
        got = sw.unpack_stage(k, buf)
        assert seen and all(b.untyped_storage().data_ptr() == ptr
                            for b in seen)
        for i, spec, pl in zip(sw.stage_leaf_ids[k], stage.specs, got):
            names, leaves = flatten_payload(pl)
            wants = flatten_payload(pls[i])[1]
            for name, o, x, want in zip(names, spec.splits, leaves, wants,
                                        strict=True):
                assert x.dtype == want.dtype, name
                assert torch.equal(x, want), name
                if x.dtype == torch.uint8:
                    assert x.untyped_storage().data_ptr() == ptr, name
                    assert x.data_ptr() == ptr + spec.offset + o, name
                    assert x.stride()[0] == stage.total_nbytes, name
                    n_u8 += 1
    assert n_u8 == (0 if w2s == "top10" else
                    2 * sum(1 for s in sw.base.specs
                            if "values_codes" in s.names))
