"""Ragged sign rows: ``pack_bits`` of any row length, and ``natural_decode``.

The reference packs each Natural slice's sign plane after padding it with
zeros to whole bytes (``pack_bits(jnp.pad(sign[:n], (0, (-n) % 8)))``,
``repro/kernels/ops.py``). The port's ``pack_bits`` takes rows of any
length n and packs each to ceil(n/8) bytes itself, the bits past n zero,
so ``natural_compress`` hands it ``natural_encode``'s sign plane as it is.
The decode, ``natural_decode``, turns codes and packed signs into bf16 in
one pass; on the card it reads both where they lie in a wire stage
buffer. Here, on the CPU (plain versions), both are held against the
reference row by row, bit for bit: contiguous rows and rows at two
strides and odd byte offsets (a codec's column of a leaf's region), the
real stage buffers of reduced nanogpt's top10+natural wire, and one EF21
round. ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the card's
kernels to the plain versions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import compressors as jcomp
from repro.core import error_feedback as jef
from repro.dist.layerwise import LayerPlan as JLayerPlan
from repro.dist.layerwise import vmap_n
from repro.kernels import bitpack as jbp
from repro.kernels import ops as jops
from repro.models.api import abstract_params as jabstract_params
from repro.models.api import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.core import compressors as comp
from repro_torch.core import error_feedback as ef
from repro_torch.dist.layerwise import LayerPlan
from repro_torch.kernels import bitpack as bp
from repro_torch.kernels import ops
from repro_torch.models.api import (abstract_params, build_model,
                                    params_from_jax)
from repro_torch.wire import codecs
from repro_torch.wire.codecs import flatten_payload

# row lengths with n mod 8 = 0..7, around a whole 16-byte output word
RAGGED_N = [128, 129, 130, 131, 132, 133, 134, 135]


def _t(x) -> torch.Tensor:
    return params_from_jax({"a": np.asarray(x)})["a"]


def _bits(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2, size=shape,
                                                dtype=np.uint8)


def _column(n_stack, offset, n, pad, fill):
    """The column ``[offset, offset + n)`` of a leaf region ``[2, n_stack,
    offset + n + pad]`` of a ``[2, T]`` buffer, T odd; ``fill(shape)``
    gives the buffer's bytes. Returns (buffer, column view)."""
    s_slice = offset + n + pad
    buf = torch.from_numpy(fill((2, n_stack * s_slice + 2 * pad + 1)))
    col = buf[:, pad:pad + n_stack * s_slice].unflatten(
        1, (n_stack, s_slice))[:, :, offset:offset + n]
    return buf, col


def _reference_pack(row: np.ndarray) -> np.ndarray:
    n = row.shape[0]
    return np.asarray(jbp.pack_bits_ref(jnp.pad(jnp.asarray(row),
                                                 (0, (-n) % 8))))


@pytest.mark.parametrize("n", RAGGED_N)
@pytest.mark.parametrize("layout", ["contiguous", "column"])
def test_pack_bits_ragged_rows_equal_reference(layout, n):
    """Rows of length n (n mod 8 = 0..7) pack to ceil(n/8) bytes, each the
    reference's pack of the row padded with zeros; the bits past n are
    zero. As a column of a leaf region the rows lie at two strides and an
    odd byte offset, the strides the card's kernel would be given."""
    if layout == "contiguous":
        x = torch.from_numpy(_bits((5, n), n))
        assert bp._row_strides(x, "pack_bits") == (1, 5, 0, n)
    else:
        buf, x = _column(3, 5, n, 7, lambda s: _bits(s, n))
        assert not x.is_contiguous()
        assert bp._row_strides(x, "pack_bits") == (2, 3, buf.stride(0),
                                                   n + 12)
    got = bp.pack_bits(x)
    assert got.shape == x.shape[:-1] + ((n + 7) // 8,)
    assert got.dtype == torch.uint8
    rows, packed = x.reshape(-1, n).numpy(), got.reshape(-1, (n + 7) // 8)
    for r in range(rows.shape[0]):
        np.testing.assert_array_equal(packed[r].numpy(),
                                      _reference_pack(rows[r]))
        if n % 8:
            assert int(packed[r, -1]) >> (n % 8) == 0


@pytest.mark.parametrize("n", [1, 7, 1003])
def test_pack_bits_ragged_equals_the_pallas_pack_of_the_padded_row(n):
    """The reference's Pallas kernel (interpret mode) on the zero-padded
    row, and back through its unpack: the row, then zeros."""
    row = _bits((n,), 100 + n)
    got = bp.pack_bits(torch.from_numpy(row)).numpy()
    padded = jnp.pad(jnp.asarray(row), (0, (-n) % 8))
    np.testing.assert_array_equal(got, np.asarray(jbp.pack_bits(
        padded, use_pallas=True, interpret=True)))
    back = np.asarray(jbp.unpack_bits(jnp.asarray(got), use_pallas=True,
                                      interpret=True))
    np.testing.assert_array_equal(back[:n], row)
    assert not back[n:].any()


def _codes_signs(lead, k, seed):
    """Random codes (every byte value, 255 included) and packed signs
    whose bits past k are zero, as the wire carries them."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, size=lead + (k,), dtype=np.uint8)
    signs = rng.integers(0, 2, size=lead + (k,), dtype=np.uint8)
    packed = bp.pack_bits(torch.from_numpy(signs)).numpy()
    return codes, packed


def _reference_decode(codes, packed, k):
    return np.asarray(jops.natural_decompress(
        jnp.asarray(codes), jnp.asarray(packed), (k,), jnp.bfloat16,
        use_pallas=False)).view(np.int16)


@pytest.mark.parametrize("k", RAGGED_N + [1, 9])
def test_natural_decode_contiguous_rows_equal_reference(k):
    codes, packed = _codes_signs((2, 3), k, k)
    got = bp.natural_decode(torch.from_numpy(codes), torch.from_numpy(packed))
    assert got.shape == (2, 3, k) and got.dtype == torch.bfloat16
    bits = got.view(torch.int16).reshape(6, k).numpy()
    for r, (c, s) in enumerate(zip(codes.reshape(6, k),
                                   packed.reshape(6, -1))):
        np.testing.assert_array_equal(bits[r], _reference_decode(c, s, k))


@pytest.mark.parametrize("offsets", [(1, 0), (3, 13), (13, 5)])
def test_natural_decode_region_columns_equal_reference(offsets):
    """Codes and signs as two columns of leaf regions at odd byte offsets
    and their own strides: decoded where they lie, row by row the
    reference's decode."""
    k = 1003
    c_off, s_off = offsets
    _, codes = _column(3, c_off, k, 7, lambda s: np.random.default_rng(
        c_off).integers(0, 256, size=s, dtype=np.uint8))
    sbuf, signs = _column(3, s_off, (k + 7) // 8, 2,
                          lambda s: np.zeros(s, np.uint8))
    signs.copy_(bp.pack_bits(torch.from_numpy(_bits((2, 3, k), s_off))))
    rc = bp._row_strides(codes, "natural_decode")
    rs = bp._row_strides(signs, "natural_decode")
    assert rc[:2] == rs[:2] == (2, 3) and rc[2:] != rs[2:]
    got = bp.natural_decode(codes, signs).view(torch.int16)
    for w in range(2):
        for j in range(3):
            np.testing.assert_array_equal(
                got[w, j].numpy(), _reference_decode(
                    codes[w, j].numpy(), signs[w, j].numpy(), k))


def test_natural_decode_operands_share_one_row_folding():
    """The card's kernel takes one row folding for both operands: views of
    one lead shape fold alike, and a contiguous operand takes the view's
    ``(n_workers, n_stack)`` with its rows at ``r * n``."""
    k = 17
    cbuf, codes = _column(3, 1, k, 2, lambda s: np.zeros(s, np.uint8))
    sbuf, signs = _column(3, 5, 3, 0, lambda s: np.zeros(s, np.uint8))
    view_c = (2, 3, cbuf.stride(0), k + 3)
    view_s = (2, 3, sbuf.stride(0), 8)
    flat_c, flat_s = codes.contiguous(), signs.contiguous()
    assert bp._decode_row_strides(codes, signs) == (view_c, view_s)
    assert bp._decode_row_strides(flat_c, signs) == ((2, 3, 3 * k, k),
                                                     view_s)
    assert bp._decode_row_strides(codes, flat_s) == (view_c, (2, 3, 9, 3))
    assert bp._decode_row_strides(flat_c, flat_s) == ((1, 6, 0, k),
                                                      (1, 6, 18, 3))


def test_natural_decode_checks_its_operands():
    code = torch.zeros((2, 17), dtype=torch.uint8)
    for sign in (torch.zeros((2, 2), dtype=torch.uint8),     # ceil(17/8) = 3
                 torch.zeros((3, 3), dtype=torch.uint8)):    # other rows
        with pytest.raises(ValueError, match="natural_decode takes"):
            bp.natural_decode(code, sign)
    with pytest.raises(ValueError, match="natural_decode takes"):
        bp.natural_decode(torch.zeros((), dtype=torch.uint8),
                          torch.zeros((1,), dtype=torch.uint8))


def _values(rows, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, n))
         * np.exp2(rng.integers(-140, 120, size=(rows, n)))).astype(
             np.float32)
    x.reshape(-1)[:4] = [0.0, -0.0, np.inf, -np.inf]
    return jnp.asarray(x).astype(jnp.bfloat16)


@pytest.mark.parametrize("n", RAGGED_N)
def test_natural_compress_and_decompress_of_ragged_rows_equal_reference(n):
    """``natural_compress`` packs the ragged sign rows with no padded copy
    and equals the reference's compress of each row; the decompress equals
    the reference's."""
    x = _values(3, n, n)
    code, packed = ops.natural_compress(_t(x))
    assert packed.shape == (3, (n + 7) // 8)
    out = ops.natural_decompress(code, packed, (3, n), torch.float32)
    for r in range(3):
        jc, js = jops.natural_compress(x[r], use_pallas=False)
        np.testing.assert_array_equal(code[r].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(packed[r].numpy(), np.asarray(js))
        np.testing.assert_array_equal(out[r].numpy(), np.asarray(
            jops.natural_decompress(jc, js, (n,), jnp.float32,
                                    use_pallas=False)))


def test_natural_decompress_bf16_is_natural_decode_itself():
    """For bf16 the decompress adds no cast: its values are the decode's
    bf16 bits, reshaped."""
    codes, packed = _codes_signs((4,), 37, 3)
    c, s = torch.from_numpy(codes), torch.from_numpy(packed)
    got = ops.natural_decompress(c, s, (4, 37))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16),
                       bp.natural_decode(c, s).view(torch.int16))


def test_ef21_round_with_top10_natural_bit_equal_to_reference():
    """One EF21 round of a ``[3, 37, 29]`` stack under TopK(0.10) + Natural
    (k = 107 values a slice: sign rows of 14 bytes, the last with 3
    bits): payloads, the new estimate and the receiver's fold equal the
    reference's bit for bit."""
    rng = np.random.default_rng(17)
    est = rng.standard_normal((3, 37, 29)).astype(np.float32)
    tgt = rng.standard_normal((3, 37, 29)).astype(np.float32)
    jc, c = (jcomp.get_compressor("top10+natural"),
             comp.get_compressor("top10+natural"))
    jpl, _, jnew = jax.vmap(lambda e, t: jef.ef_compress_step(
        jc, {}, e, t))(jnp.asarray(est), jnp.asarray(tgt))
    pl, _, new = ef.ef_compress_step(c, {}, torch.from_numpy(est),
                                     torch.from_numpy(tgt), (37, 29))
    assert pl["values_signs"].shape == (3, 14)
    for name in jpl:
        np.testing.assert_array_equal(pl[name].numpy(),
                                      np.asarray(jpl[name]), err_msg=name)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
    np.testing.assert_array_equal(
        ef.apply_payload(c, pl, torch.from_numpy(est)).numpy(),
        np.asarray(jnew))


def test_stage_buffer_columns_decode_in_place_equal_reference():
    """Reduced nanogpt's top10+natural wire, 2 workers: every stage packed
    and unpacked; each Natural leaf's ``values_codes`` and
    ``values_signs`` come back as views of the stage buffer (odd byte
    offsets, the buffer's row stride), and ``natural_decode`` of the two
    views equals the reference's decode of the reference payload, row by
    row."""
    jcfg = jget_config("nanogpt-124m").reduced()
    cfg = get_config("nanogpt-124m").reduced()
    jplan = JLayerPlan.build(*jabstract_params(jbuild_model(jcfg)),
                             w2s="top10+natural")
    plan = LayerPlan.build(*abstract_params(build_model(cfg)),
                           w2s="top10+natural")
    rng = np.random.default_rng(23)
    jpls = []
    for lp in jplan.leaves:
        x = jnp.asarray(rng.standard_normal((2,) + lp.shape), jnp.float32)
        if not getattr(lp.w2s, "lossless_wire", False):
            x = x.astype(jnp.bfloat16)
        jpls.append(vmap_n(lambda s, c=lp.w2s: c.compress({}, s)[0],
                           lp.meta.stack_dims + 1)(x))
    pls = []
    for p in jpls:
        names, leaves = flatten_payload(p)
        pls.append(codecs.unflatten_payload(names, [_t(x) for x in leaves]))
    sw = plan.staged_wire_layout(torch.bfloat16, plan.stage_plan())
    n_leaves, offsets = 0, set()
    for k in range(sw.n_stages):
        buf = sw.pack_stage(k, pls)
        for i, pl in zip(sw.stage_leaf_ids[k], sw.unpack_stage(k, buf)):
            if not isinstance(pl, dict) or "values_codes" not in pl:
                continue
            codes, signs = pl["values_codes"], pl["values_signs"]
            for v in (codes, signs):
                assert v.untyped_storage().data_ptr() == \
                    buf.untyped_storage().data_ptr()
                assert v.stride(0) == buf.stride(0)
                offsets.add(v.storage_offset() % 2)
            got = bp.natural_decode(codes, signs).view(torch.int16)
            kk = codes.shape[-1]
            jc = np.asarray(jpls[i]["values_codes"]).reshape(-1, kk)
            js = np.asarray(jpls[i]["values_signs"]).reshape(jc.shape[0], -1)
            for r, row in enumerate(got.reshape(-1, kk)):
                np.testing.assert_array_equal(
                    row.numpy(), _reference_decode(jc[r], js[r], kk))
            n_leaves += 1
    assert n_leaves == sum(1 for s in sw.base.specs
                           if "values_codes" in s.names) > 0
    assert 1 in offsets    # some column starts at an odd byte
