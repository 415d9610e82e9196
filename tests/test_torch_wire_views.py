"""The narrow decode reads column slices of a wire buffer in place.

The wire's stage buffer holds each slice's payload leaves side by side,
so ``NarrowIntCodec.unpack`` gets a column slice ``buf[:, o:o + n]`` (of a
leaf's region ``[n_workers, n_stack, slice_nbytes]``): rows at two
strides, starting at any byte offset. The port's ``narrow_decode`` takes
such a view without a copy (on the card its kernel reads the rows where
they lie). Here, on the CPU, the same views go through the plain version
and must equal the reference's ``narrow_decode_ref`` row by row, bit for
bit; the row strides the card's kernel would be given are checked beside
it, and the codec is shown to hand over the view itself.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.dist.layerwise import LayerPlan as JLayerPlan
from repro.kernels import bitpack as jbp
from repro.models.api import abstract_params as jabstract_params
from repro.models.api import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.dist.layerwise import LayerPlan
from repro_torch.kernels import bitpack as bp
from repro_torch.models.api import abstract_params, build_model
from repro_torch.wire import codecs
from repro_torch.wire.codecs import NarrowIntCodec


def _buffer(rows: int, cols: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, size=(rows, cols), dtype=np.uint8))


@pytest.mark.parametrize("k", [1, 7, 129, 1003])
@pytest.mark.parametrize("width", [2, 3, 4])
@pytest.mark.parametrize("offset", [0, 1, 3, 5])
def test_narrow_decode_column_slice_equals_reference(offset, width, k):
    """A column slice at byte offset ``offset`` of a [3, S] buffer whose
    row stride S is not width * k: decoded in place, row by row equal to
    the reference's plain decode of the same bytes."""
    rows, n = 3, width * k
    stride = offset + n + 5
    buf = _buffer(rows, stride, seed=offset * 1000 + width * 100 + k)
    view = buf[:, offset:offset + n]
    assert not view.is_contiguous()
    assert bp._row_strides(view, "narrow_decode") == (1, rows, 0, stride)
    got = bp.narrow_decode(view, width)
    assert got.shape == (rows, k) and got.dtype == torch.int32
    for r in range(rows):
        want = np.asarray(jbp.narrow_decode_ref(
            jnp.asarray(buf[r, offset:offset + n].numpy()), width))
        np.testing.assert_array_equal(got[r].numpy(), want)


def _row_starts(t: torch.Tensor) -> list[int]:
    """Each row's first element, counted from the view's first element."""
    lead = t.shape[:-1]
    return [sum(i * st for i, st in zip(np.unravel_index(r, lead),
                                        t.stride()))
            for r in range(int(np.prod(lead)))]


@pytest.mark.parametrize("make,want", [
    (lambda b: b[:, 3:15], (1, 10, 0, 40)),           # column slice
    (lambda b: b[::2, :12], (1, 5, 0, 80)),           # every other row
    (lambda b: b[:1, 7:19], (1, 1, 0, 12)),           # one row: contiguous
    (lambda b: b[:, :12].contiguous(), (1, 10, 0, 12)),
    (lambda b: b.reshape(10, 5, 8), (1, 50, 0, 8)),   # contiguous, 3-D
    (lambda b: b.reshape(-1), (1, 1, 0, 400)),        # contiguous, 1-D
    (lambda b: b.reshape(2, 5, 40)[:, :, 3:15], (2, 5, 200, 40)),  # region
    (lambda b: b.reshape(2, 5, 1, 40)[:, 1:, :, 7:9], (2, 4, 200, 40)),
])
def test_row_stride_of_views_the_kernel_reads(make, want):
    """(n_workers, n_stack, s_worker, s_slice), and the row starts they
    give are the view's own."""
    t = make(_buffer(10, 40, 0))
    n_workers, n_stack, s_worker, s_slice = bp._row_strides(
        t, "narrow_decode")
    assert (n_workers, n_stack, s_worker, s_slice) == want
    assert n_workers * n_stack == t.numel() // t.shape[-1]
    if t.ndim > 1:
        assert _row_starts(t) == [w * s_worker + j * s_slice
                                  for w in range(n_workers)
                                  for j in range(n_stack)]


@pytest.mark.parametrize("make", [
    lambda b: b.mT[:, :12],                      # last dim not stride 1
    lambda b: b[:, ::2],                         # last dim stride 2
    lambda b: b.reshape(2, 5, 5, 8)[:, :, 1:4],  # stack dims do not fold
    lambda b: b.reshape(-1)[::3],                # 1-D, not contiguous
    lambda b: b.as_strided((4, 12), (6, 1)),     # rows overlap
    lambda b: b.as_strided((2, 3, 12), (30, 12, 1)),  # workers overlap
])
def test_row_stride_refuses_other_views(make):
    with pytest.raises(ValueError, match="stride 1 in the last dimension"):
        bp._row_strides(make(_buffer(10, 40, 0)), "narrow_decode")


def _reduced_top10_specs():
    jcfg, cfg = jget_config("nanogpt-124m").reduced(), \
        get_config("nanogpt-124m").reduced()
    jplan = JLayerPlan.build(*jabstract_params(jbuild_model(jcfg)),
                             w2s="top10")
    plan = LayerPlan.build(*abstract_params(build_model(cfg)), w2s="top10")
    return (jplan.wire_layout(jnp.bfloat16).specs,
            plan.wire_layout(torch.bfloat16).specs)


def test_narrow_codec_unpack_reads_the_buffer_in_place(monkeypatch):
    """Every narrow codec of reduced nanogpt's top10 wire hands
    ``narrow_decode`` the column slice of the rows buffer itself (same
    storage, the split's offset, the buffer's row stride), and the
    indices it returns equal the reference codec's unpack of each row."""
    seen = []
    real = codecs.narrow_decode

    def recording(b, width):
        seen.append(b)
        return real(b, width)

    monkeypatch.setattr(codecs, "narrow_decode", recording)
    jspecs, specs = _reduced_top10_specs()
    n_narrow = 0
    for i, (jspec, spec) in enumerate(zip(jspecs, specs, strict=True)):
        rows = 2 * spec.n_stack
        buf = _buffer(rows, spec.slice_nbytes, seed=i)
        seen.clear()
        leaves = codecs.flatten_payload(spec.unpack_rows(buf))[1]
        narrow = [(j, c) for j, c in enumerate(spec.codecs)
                  if isinstance(c, NarrowIntCodec)]
        assert len(seen) == len(narrow)
        for b, (j, c) in zip(seen, narrow):
            o = spec.splits[j]
            assert b.untyped_storage().data_ptr() == \
                buf.untyped_storage().data_ptr()
            assert b.data_ptr() == buf.data_ptr() + o
            assert b.shape == (rows, c.nbytes)
            assert b.stride() == (spec.slice_nbytes, 1)
            jc = jspec.codecs[j]
            for r in range(rows):
                want = np.asarray(jc.unpack(
                    jnp.asarray(buf[r, o:o + c.nbytes].numpy())))
                np.testing.assert_array_equal(leaves[j][r].numpy(), want)
            n_narrow += 1
    assert n_narrow > 0
