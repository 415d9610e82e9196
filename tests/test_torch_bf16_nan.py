"""The port's f32 -> bf16 cast keeps XLA's bits, NaN included.

XLA casts every f32 NaN to ``sign | 0x7FC0``; PyTorch's CPU cast gives
0xFFFF (vectorised) or 0x7FC0 (0-d), and its CUDA cast its own NaN. The
port casts through ``to_bf16`` (``kernels/natural_pack.py``; on the CPU
its plain version ``ref.to_bf16_ref``), so a NaN in the EF21 target
reaches the wire, and the estimates, with the reference's bits. Here the
cast is held against ``jnp.asarray(x).astype(jnp.bfloat16)`` bit for bit,
and one EF21 round with NaNs in the target against the reference's.
The CUDA kernel is held against the same plain version in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jcomp
from repro.core import error_feedback as jef
from repro_torch.core import compressors as comp
from repro_torch.core import error_feedback as ef
from repro_torch.kernels import ref
from repro_torch.kernels.natural_pack import natural_encode, to_bf16
from test_torch_threads import one_torch_thread  # noqa: F401

# quiet and signalling NaNs of both signs, with and without payload bits
NAN_BITS = [0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FFFFFFF,
            0xFFFFFFFF, 0x7FA00000, 0xFFA00000]
# +-inf, +-0, subnormals (the smallest, one rounding to a bf16
# subnormal, the largest), round-to-nearest-even ties and their
# neighbours, the largest finite f32 (rounds to inf) and bf16's largest
OTHER_BITS = [0x7F800000, 0xFF800000, 0x00000000, 0x80000000, 0x00000001,
              0x80000001, 0x00018000, 0x00008000, 0x007FFFFF, 0x807FFFFF,
              0x3F808000, 0x3F818000, 0x3F808001, 0xBF818000, 0x7F7FFFFF,
              0x7F7F7FFF, 0xFF7F8000]


def _f32(bits) -> np.ndarray:
    return np.array(bits, np.uint32).view(np.float32)


def _bits16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _xla_bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)


@pytest.mark.parametrize("bits", NAN_BITS + OTHER_BITS,
                         ids=lambda b: f"{b:#010x}")
def test_to_bf16_scalar_matches_xla(bits):
    """A 0-d tensor: PyTorch's own 0-d cast drops a NaN's sign."""
    x = _f32(bits)
    got = _bits16(to_bf16(torch.from_numpy(x.copy()).reshape(())))
    assert got == _xla_bits(x)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 64, 1003])
def test_to_bf16_vector_matches_xla(n):
    """Vectors (PyTorch's vectorised CPU cast maps every NaN to 0xFFFF):
    the special patterns scattered among random values over the whole f32
    range."""
    rng = np.random.default_rng(n)
    raw = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    special = np.array(NAN_BITS + OTHER_BITS, np.uint32)
    m = min(n, special.size)
    raw[rng.choice(n, m, replace=False)] = special[:m]
    x = raw.view(np.float32)
    got = _bits16(to_bf16(torch.from_numpy(x.copy())))
    np.testing.assert_array_equal(got, _xla_bits(x))


def test_to_bf16_agrees_with_torch_cast_off_nan_and_passes_bf16():
    x = _f32(OTHER_BITS)
    t = torch.from_numpy(x.copy())
    np.testing.assert_array_equal(_bits16(to_bf16(t)),
                                  _bits16(t.to(torch.bfloat16)))
    b = t.to(torch.bfloat16)
    assert to_bf16(b) is b
    with pytest.raises(TypeError, match="float32"):
        to_bf16(t.double())


def test_natural_encode_f32_nan_takes_the_sign_of_the_nan():
    """Natural's code of any NaN is 254 and its sign the NaN's sign bit:
    +2^127 or -2^127 after decompression, as in the reference."""
    from repro.kernels import ref as jref
    x = _f32(NAN_BITS + OTHER_BITS)
    code, sign = natural_encode(torch.from_numpy(x.copy()))
    jc, js = jref.natural_compress_ref(jnp.asarray(x))
    np.testing.assert_array_equal(code.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(js))
    assert sign[:len(NAN_BITS)].tolist() == [b >> 31 for b in NAN_BITS]
    assert code[:len(NAN_BITS)].tolist() == [254] * len(NAN_BITS)
    np.testing.assert_array_equal(ref.natural_compress_ref(
        torch.from_numpy(x.copy()))[1].numpy(), np.asarray(js))


def _payload_bits(pl):
    """A payload's leaves as raw bytes (NaN bits compare exactly)."""
    if not isinstance(pl, dict):
        pl = {None: pl}
    return {k: np.asarray(v).view(np.uint8) if isinstance(v, np.ndarray)
            else v.contiguous().view(torch.uint8).numpy()
            for k, v in pl.items()}


@pytest.mark.parametrize("name", ["top10", "natural", "top10+natural"])
def test_ef_compress_step_with_nan_in_target_equals_reference(name):
    """One EF21 round whose target holds NaNs of both signs (and inf):
    equal payload bytes and equal new estimates, NaN bits included."""
    rng = np.random.default_rng(7)
    est = rng.standard_normal((40, 24)).astype(np.float32)
    tgt = rng.standard_normal((40, 24)).astype(np.float32) * 4
    flat = tgt.reshape(-1)
    flat[[3, 50, 51, 200, 777]] = _f32([0x7FC00000, 0xFFC00000, 0xFF800001,
                                        0x7FFFFFFF, 0x7F800000])
    jc, c = jcomp.get_compressor(name), comp.get_compressor(name)
    jpl, _, jnew = jef.ef_compress_step(jc, {}, jnp.asarray(est),
                                        jnp.asarray(tgt))
    pl, _, new = ef.ef_compress_step(c, {}, torch.from_numpy(est),
                                     torch.from_numpy(tgt), (40, 24))
    want = _payload_bits({k: np.asarray(v) for k, v in jpl.items()}
                         if isinstance(jpl, dict) else np.asarray(jpl))
    got = _payload_bits(pl)
    assert sorted(got, key=str) == sorted(want, key=str)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    np.testing.assert_array_equal(new.numpy().view(np.uint32),
                                  np.asarray(jnew).view(np.uint32))
    assert np.isnan(new.numpy()).any() == (name == "top10")
