"""Parity of the port's Natural compression with the reference's.

The ``natural_encode`` kernel's plain version against the reference's
jnp version and its Pallas kernel in interpret mode; ``natural_compress``
/ ``natural_decompress`` over rows; the ``Natural`` and ``WithNatural``
payloads, decompressed values, payload bytes and one EF21 round. All of
it is bit logic on bf16 bit patterns, so it must agree exactly. NaN is
left out: an f32 -> bf16 cast of NaN need not keep its sign bit alike
in XLA and PyTorch. The CUDA kernel is held against the same plain
version in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import compressors as jcomp
from repro.core import error_feedback as jef
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import compressors as comp
from repro_torch.core import error_feedback as ef
from repro_torch.kernels import ops, ref
from repro_torch.kernels.natural_pack import natural_encode
from repro_torch.models.api import params_from_jax

# +-0, the smallest and largest f32 subnormals, values whose top
# mantissa bit (bf16 bit 6) is set or just clear, bf16's largest finite
# value and its round-up, +-inf
SPECIAL = np.array([0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, 1.5, -1.5,
                    1.49, 0.75, -0.7499, 3.3895314e38, 3.39e38, -3.39e38,
                    np.inf, -np.inf], np.float32)


def _t(x) -> torch.Tensor:
    return params_from_jax({"a": np.asarray(x)})["a"]


def _values(rows, n, seed, dtype):
    """Normals spread over many binades, the special values mixed in."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, n))
         * np.exp2(rng.integers(-140, 120, size=(rows, n)))).astype(
             np.float32)
    flat = x.reshape(-1)
    m = min(flat.size, SPECIAL.size)
    flat[rng.choice(flat.size, m, replace=False)] = SPECIAL[:m]
    return jnp.asarray(x).astype(dtype)


@settings(max_examples=10, deadline=None)
@given(rows=st.integers(1, 3), n=st.sampled_from([1, 7, 8, 127, 300, 1025]),
       dtype=st.sampled_from(["float32", "bfloat16"]),
       seed=st.integers(0, 2**16))
def test_natural_encode_matches_reference_and_pallas(rows, n, dtype, seed):
    """Codes and sign planes of f32 and bf16 rows == the reference's
    jnp version and its Pallas kernel (interpret, through
    ``natural_compress(use_pallas=True)``, which also packs the signs)."""
    x = _values(rows, n, seed, jnp.dtype(dtype))
    code, sign = natural_encode(_t(x))
    assert code.shape == sign.shape == (rows, n)
    for r in range(rows):
        jc, js = jref.natural_compress_ref(x[r])
        np.testing.assert_array_equal(code[r].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(sign[r].numpy(), np.asarray(js))
        pc, ps = jops.natural_compress(x[r], use_pallas=True, interpret=True)
        np.testing.assert_array_equal(np.asarray(pc), np.asarray(jc))
        np.testing.assert_array_equal(
            ops.natural_compress(_t(x[r]))[1].numpy(), np.asarray(ps))


def test_natural_decompress_ref_is_the_reference_inverse():
    codes = np.arange(256, dtype=np.uint8).repeat(2)
    signs = np.tile(np.array([0, 1], np.uint8), 256)
    want = np.asarray(jref.natural_decompress_ref(jnp.asarray(codes),
                                                  jnp.asarray(signs)))
    got = ref.natural_decompress_ref(torch.from_numpy(codes),
                                     torch.from_numpy(signs))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("rows,n", [(1, 1), (3, 7), (2, 64), (4, 1003)])
def test_natural_compress_pads_signs_per_row(rows, n):
    """Each row is its own message: its sign bitmap is padded to a whole
    byte on its own, as the reference pads each slice."""
    x = _values(rows, n, 7, jnp.bfloat16)
    code, packed = ops.natural_compress(_t(x))
    assert packed.shape == (rows, -(-n // 8))
    out = ops.natural_decompress(code, packed, (rows, n), torch.float32)
    for r in range(rows):
        jc, js = jops.natural_compress(x[r], use_pallas=False)
        np.testing.assert_array_equal(code[r].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(packed[r].numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            out[r].numpy(), np.asarray(jops.natural_decompress(
                jc, js, (n,), jnp.float32, use_pallas=False)))


# ------------------------------------------------------------ compressors

NATURAL_NAMES = ["natural", "identity+natural", "top10+natural",
                 "top15+natural"]


@pytest.mark.parametrize("name", NATURAL_NAMES)
@pytest.mark.parametrize("slice_shape", [(48, 32), (3, 5, 7), (61,)])
def test_natural_payloads_and_values_equal_reference(name, slice_shape):
    """Payloads of a [2, 3, *slice] stack (every leading index its own
    message) equal the reference's vmapped compress leaf for leaf, and
    the decompressed values equal the reference's."""
    lead = (2, 3)
    x = _values(6, int(np.prod(slice_shape)), 9, jnp.bfloat16).reshape(
        lead + slice_shape)
    jc, c = jcomp.get_compressor(name), comp.get_compressor(name)
    jpl = jax.vmap(jax.vmap(lambda s: jc.compress({}, s)[0]))(x)
    pl, _ = c.compress({}, _t(x), slice_shape)
    assert sorted(pl) == sorted(jpl)
    for k in jpl:
        assert pl[k].dtype == _t(jpl[k]).dtype, k
        np.testing.assert_array_equal(pl[k].numpy(), np.asarray(jpl[k]),
                                      err_msg=k)
    want = jax.vmap(jax.vmap(lambda p: jc.decompress(
        p, slice_shape, jnp.float32)))(jpl)
    np.testing.assert_array_equal(
        c.decompress(pl, lead + slice_shape, torch.float32).numpy(),
        np.asarray(want))
    assert c.name == jc.name
    assert c.payload_bytes(slice_shape, torch.bfloat16) == \
        jc.payload_bytes(slice_shape, jnp.bfloat16)


@pytest.mark.parametrize("name", NATURAL_NAMES)
def test_ef_compress_step_bit_equal_with_natural(name):
    rng = np.random.default_rng(13)
    est = rng.standard_normal((40, 24)).astype(np.float32)
    tgt = rng.standard_normal((40, 24)).astype(np.float32)
    jc, c = jcomp.get_compressor(name), comp.get_compressor(name)
    _, _, jnew = jef.ef_compress_step(jc, {}, jnp.asarray(est),
                                      jnp.asarray(tgt))
    tpl, _, tnew = ef.ef_compress_step(c, {}, torch.from_numpy(est),
                                       torch.from_numpy(tgt), (40, 24))
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    np.testing.assert_array_equal(
        ef.apply_payload(c, tpl, torch.from_numpy(est)).numpy(),
        np.asarray(jnew))


def test_natural_payloads_on_meta_tensors_have_reference_shapes():
    """The wire layout derives payload structure on the meta device."""
    x = torch.zeros((2, 768, 768), dtype=torch.bfloat16, device="meta")
    pl, _ = comp.get_compressor("top10+natural").compress({}, x, (768, 768))
    assert {k: (tuple(v.shape), v.dtype) for k, v in pl.items()} == {
        "indices": ((2, 58983), torch.int32),
        "values_codes": ((2, 58983), torch.uint8),
        "values_signs": ((2, 7373), torch.uint8)}
