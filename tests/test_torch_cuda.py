"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips without a card (the kernels have no CPU
mode). This file imports neither JAX nor the reference package, so it
also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_cuda.py

``python3 chip_smoke.py`` runs the same checks at nanogpt's full-width
shapes. Newton-Schulz tolerances are max|kernel - plain| / max|plain|:
the plain side is cuBLAS in true f32 (TF32 off), the kernels are 3xTF32
on the tensor cores (f32-accurate products, each 64-deep span of K
summed apart and added in f32), so the two differ by summation order and
the split's ~2^-22 residual per product. The wire's bit-packing and Natural kernels are bit logic, so they
must equal their plain versions exactly (``torch.equal``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import bitpack as bp
from repro_torch.kernels import natural_pack as nat
from repro_torch.kernels import ops, ref
from repro_torch.kernels.newton_schulz import (LAUNCHES, fused_matmul,
                                               ns_iteration, reset_launches,
                                               syrk_upper)

pytestmark = pytest.mark.cuda

ONE_PASS = 1e-5     # one GEMM / one NS iteration
NS_CHAIN = 1e-4     # 5 chained NS iterations


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(shape, seed, dev, normalise=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if normalise:
        x /= np.sqrt(np.sum(x * x, axis=(-2, -1), keepdims=True))
    return torch.from_numpy(x).to(dev)


def _wide(shape, seed, dev, normalise=False):
    """Entries whose magnitudes span ~2^20 (a random power of two in
    [2^-10, 2^10] per entry): a product that loses the lo part of the
    3xTF32 split is off by ~2^-11 of its largest terms."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape)
         * np.exp2(rng.integers(-10, 11, size=shape))).astype(np.float32)
    if normalise:
        x /= np.sqrt(np.sum(x * x, axis=(-2, -1), keepdims=True))
    return torch.from_numpy(x).to(dev)


def _rel(got, want):
    torch.cuda.synchronize()
    return ((got - want).abs().max() / want.abs().max()).item()


def test_ns_iteration_and_its_launches(dev):
    """Gram and poly on the symmetric kernel, the update on fused_matmul:
    three launches."""
    x = _t((3, 200, 328), 0, dev, normalise=True)
    reset_launches()
    got = ns_iteration(x)
    assert LAUNCHES == {"ns_iteration": 2, "fused_matmul": 1}
    assert _rel(got, ref.ns_iteration_batched_ref(x)) <= ONE_PASS


@pytest.mark.parametrize("shape", [(48, 768, 768), (24, 768, 3072)])
def test_ns_main_path_shapes(dev, shape):
    """nanogpt-124m's two NS buckets: one iteration, and the 5-iteration
    chain of the LMO."""
    x = _t(shape, 10, dev, normalise=True)
    assert _rel(ns_iteration(x), ref.ns_iteration_batched_ref(x)) <= ONE_PASS
    assert _rel(ops.newton_schulz_batched(x, steps=5),
                ref.newton_schulz_batched_ref(x, steps=5)) <= NS_CHAIN


@pytest.mark.parametrize("shape", [(4, 768, 3072), (3, 200, 328)])
def test_wide_magnitude_inputs(dev, shape):
    """Entries spanning ~2^20 through both kernels and one iteration."""
    x = _wide(shape, 11, dev, normalise=True)
    y = _wide(shape, 12, dev)
    c = _wide(shape[:2] + (shape[1],), 13, dev)
    assert _rel(fused_matmul(x, y, trans_b=True),
                ref.fused_matmul_ref(x, y.mT, None)) <= ONE_PASS
    g = ref.syrk_upper_ref(x)
    assert _rel(fused_matmul(g, x, x, alpha=0.5, beta=2.0),
                ref.fused_matmul_ref(g, x, x, 0.5, 2.0)) <= ONE_PASS
    assert _rel(syrk_upper(y, c + c.mT, alpha=-0.3, beta=1.7),
                ref.syrk_upper_ref(y, c + c.mT, -0.3, 1.7)) <= ONE_PASS
    assert _rel(ns_iteration(x), ref.ns_iteration_batched_ref(x)) <= ONE_PASS


@pytest.mark.parametrize("shape", [(2, 130, 77), (3, 200, 328), (130, 77),
                                   (1, 1, 5)])
@pytest.mark.parametrize("with_c", [False, True])
def test_syrk_upper_ragged(dev, shape, with_c):
    """The symmetric kernel off the tile and, at K = 77, with rows that
    are not 16-byte aligned (the 4-byte copy path); the result is exactly
    symmetric and C is read on its upper triangle only."""
    x = _t(shape, 14, dev)
    c = _t(shape[:-1] + (shape[-2],), 15, dev) if with_c else None
    reset_launches()
    got = syrk_upper(x, c, alpha=0.7, beta=-1.3)
    assert LAUNCHES == {"ns_iteration": 1, "fused_matmul": 0}
    assert torch.equal(got, got.mT)
    assert _rel(got, ref.syrk_upper_ref(x, c, 0.7, -1.3)) <= ONE_PASS


@pytest.mark.parametrize("trans_b,with_c", [(False, False), (True, True),
                                            (True, False), (False, True)])
def test_fused_matmul_ragged(dev, trans_b, with_c):
    a = _t((2, 130, 77), 1, dev)
    b = _t((2, 259, 77) if trans_b else (2, 77, 259), 2, dev)
    c = _t((2, 130, 259), 3, dev) if with_c else None
    got = fused_matmul(a, b, c, alpha=0.7, beta=-1.3, trans_b=trans_b)
    want = ref.fused_matmul_ref(a, b.mT if trans_b else b, c, 0.7, -1.3)
    assert _rel(got, want) <= ONE_PASS


@pytest.mark.parametrize("chunked", [False, True])
def test_newton_schulz_paths(dev, chunked, monkeypatch):
    """Whole stacks, and one slice per ns_iteration (a one-byte workspace
    budget): 5 iterations x 3 launches per chunk."""
    if chunked:
        monkeypatch.setattr(ops, "NS_WORKSPACE_BUDGET", 1)
    g = _t((2, 128, 384), 4, dev)
    reset_launches()
    assert _rel(ops.newton_schulz_batched(g),
                ref.newton_schulz_batched_ref(g)) <= NS_CHAIN
    chunks = 2 if chunked else 1
    assert LAUNCHES == {"ns_iteration": 10 * chunks,
                        "fused_matmul": 5 * chunks}
    g2 = _t((300, 130), 5, dev)
    assert _rel(ops.newton_schulz(g2),
                ref.newton_schulz_ref(g2)) <= NS_CHAIN


def test_wrappers_raise_instead_of_falling_back(dev):
    x = _t((2, 64, 96), 6, dev)
    with pytest.raises(TypeError, match="float32"):
        ns_iteration(x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        ns_iteration(x.mT)
    with pytest.raises(ValueError, match="on cpu"):
        fused_matmul(x, x.cpu(), trans_b=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_matmul(x, x)
    with pytest.raises(ValueError, match="c must be"):
        syrk_upper(x, x)
    with pytest.raises(TypeError, match="float32"):
        syrk_upper(x.double())


# ------------------------------------------------------- wire kernels

ROWS_K = [(1, 1), (3, 7), (2, 129), (24, 1000), (2, 78_644)]


@pytest.mark.parametrize("rows,k", ROWS_K)
@pytest.mark.parametrize("width", [2, 3, 4])
def test_narrow_kernels_bit_equal(dev, rows, k, width):
    hi = min(1 << (8 * width), 2**31)
    x = np.random.default_rng(k).integers(0, hi, size=(rows, k))
    x.flat[0] = hi - 1
    idx = torch.from_numpy(x.astype(np.int32)).to(dev)
    bp.reset_launches()
    enc = bp.narrow_encode(idx, width)
    assert torch.equal(enc, bp.narrow_encode_ref(idx, width))
    dec = bp.narrow_decode(enc, width)
    assert torch.equal(dec, bp.narrow_decode_ref(enc, width))
    assert torch.equal(dec, idx)
    assert bp.LAUNCHES["narrow_encode"] == bp.LAUNCHES["narrow_decode"] == 1


@pytest.mark.parametrize("rows,k", ROWS_K)
def test_bit_kernels_bit_equal(dev, rows, k):
    bits = torch.from_numpy(np.random.default_rng(k).integers(
        0, 2, size=(rows, 8 * k)).astype(np.uint8)).to(dev)
    bp.reset_launches()
    packed = bp.pack_bits(bits)
    assert torch.equal(packed, bp.pack_bits_ref(bits))
    # an input that is not 8-byte aligned takes the byte-wise path
    assert torch.equal(bp.pack_bits(bits.reshape(-1)[1:-7]),
                       bp.pack_bits_ref(bits.reshape(-1)[1:-7]))
    assert torch.equal(bp.unpack_bits(packed), bits)
    codes = torch.randint(0, 256, bits.shape, dtype=torch.uint8, device=dev)
    assert torch.equal(bp.natural_decode(codes, packed).view(torch.int16),
                       bp.natural_decode_ref(codes, packed).view(torch.int16))
    assert bp.LAUNCHES["pack_bits"] == 1 + (bits.numel() > 8)
    assert bp.LAUNCHES["unpack_bits"] == 1
    assert bp.LAUNCHES["natural_decode"] == 1


def _natural_values(shape, seed) -> np.ndarray:
    """Values spanning the bf16 exponent range, led by the specials (+-0,
    subnormals, the bf16 overflow edge, +-inf, NaN)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape)
         * np.exp2(rng.integers(-140, 120, size=shape))).astype(np.float32)
    special = np.array([0.0, -0.0, 1e-45, -1e-40, 1.5, -0.75, 3.39e38,
                        np.inf, -np.inf, np.nan], np.float32)
    m = min(x.size, special.size)
    x.reshape(-1)[:m] = special[:m]
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,k", ROWS_K)
def test_natural_encode_bit_equal(dev, dtype, rows, k):
    xt = torch.from_numpy(_natural_values((rows, k), k)).to(dev).to(dtype)
    nat.reset_launches()
    code, sign = nat.natural_encode(xt)
    want_code, want_sign = ref.natural_compress_ref(xt)
    assert torch.equal(code, want_code) and torch.equal(sign, want_sign)
    assert nat.LAUNCHES["natural_encode"] == 1
    c2, s2 = ops.natural_compress(xt)
    assert torch.equal(ops.natural_decompress(c2, s2, xt.shape),
                       ref.natural_decompress_ref(want_code, want_sign))


# nanogpt-124m's packed wire (2 workers): the narrow leaves' (rows, k) at
# width 3, and the Natural leaves' (rows, k)
MAIN_NARROW = [(24, 58_983), (24, 235_930), (2, 78_644)]
MAIN_NATURAL = [(24, 58_983), (24, 235_930), (2, 3_863_348), (2, 78_644)]
# lengths around the vector widths (Natural: 8 elements, narrow decode:
# groups of 4)
AROUND_VECTOR = [7, 8, 9, 15, 16, 17]


def _decode_equal(view, width):
    bp.reset_launches()
    got = bp.narrow_decode(view, width)
    assert bp.LAUNCHES["narrow_decode"] == 1
    assert torch.equal(got, bp.narrow_decode_ref(view, width))


def _encode_equal(x):
    nat.reset_launches()
    code, sign = nat.natural_encode(x)
    assert nat.LAUNCHES["natural_encode"] == 1
    want_code, want_sign = ref.natural_compress_ref(x)
    assert torch.equal(code, want_code) and torch.equal(sign, want_sign)


def _bytes(shape, seed, dev):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, size=shape, dtype=np.uint8)).to(dev)


@pytest.mark.parametrize("rows,k", MAIN_NARROW + [(3, k) for k in
                                                  AROUND_VECTOR])
def test_narrow_decode_main_shapes_and_vector_edges(dev, rows, k):
    for width in (2, 3, 4):
        _decode_equal(_bytes((rows, width * k), k, dev), width)


@pytest.mark.parametrize("rows,k", [(1, 9_000_001), (65_537, 5)])
def test_narrow_decode_past_the_grid_limits(dev, rows, k):
    """A row longer than a grid row of blocks ever needs at once, and more
    rows than the grid's 65,535 in y (the kernel loops over rows)."""
    _decode_equal(_bytes((rows, 3 * k), 1, dev), 3)


@pytest.mark.parametrize("offset", range(1, 16))
def test_narrow_decode_at_storage_offsets(dev, offset):
    """A u8 input 1-15 bytes into a larger buffer: no plane is aligned."""
    for rows, k in ((3, 7), (2, 1003), (24, 4099)):
        buf = _bytes((rows * 3 * k + 16,), offset, dev)
        _decode_equal(buf[offset:offset + rows * 3 * k].view(rows, 3 * k), 3)


@pytest.mark.parametrize("offset,pad", [(0, 1), (1, 0), (3, 7), (5, 13),
                                        (7, 2), (13, 9)])
@pytest.mark.parametrize("width", [2, 3, 4])
def test_narrow_decode_column_slices(dev, offset, pad, width):
    """Column slices of a [R, S] stage-like buffer, read in place at odd
    byte offsets and row strides (S = offset + width * k + pad)."""
    for rows, k in ((24, 58_983), (5, 1003), (3, 17)):
        n = width * k
        buf = _bytes((rows, offset + n + pad), offset + pad, dev)
        _decode_equal(buf[:, offset:offset + n], width)


@pytest.mark.parametrize("rows,k", MAIN_NATURAL + [(3, k) for k in
                                                   AROUND_VECTOR])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_natural_encode_main_shapes_and_vector_edges(dev, rows, k, dtype):
    """The main path's Natural leaves (the 2 x 3,863,348 one walks the
    grid-stride loop more than once), and lengths around the vector."""
    _encode_equal(torch.from_numpy(_natural_values((rows, k), k)).to(
        dev).to(dtype))


@pytest.mark.parametrize("offset", range(1, 16))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_natural_encode_at_storage_offsets(dev, offset, dtype):
    """Inputs 1-15 elements into a larger buffer (f32 at byte offsets 4-60;
    bf16 at 2-30, odd element offsets among them): the vector body starts
    after a scalar head, or the scalar loop takes the whole range where no
    element aligns input and outputs."""
    for n in (9, 1003, 3 * 58_983):
        buf = torch.from_numpy(_natural_values((n + 16,), n)).to(dev).to(
            dtype)
        _encode_equal(buf[offset:offset + n])


def test_wire_wrappers_raise_instead_of_falling_back(dev):
    x = torch.zeros((2, 16), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError, match="int32"):
        bp.narrow_encode(x, 3)
    with pytest.raises(ValueError, match="contiguous"):
        bp.pack_bits(torch.zeros((16, 2), dtype=torch.uint8,
                                 device=dev).mT)
    with pytest.raises(TypeError, match="float32"):
        nat.natural_encode(torch.zeros(8, dtype=torch.float16, device=dev))
    # a last dimension that is not stride 1: raised, never copied
    b = torch.zeros((12, 6), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="stride 1 in the last dimension"):
        bp.narrow_decode(b.mT, 3)
    with pytest.raises(ValueError, match="stride 1 in the last dimension"):
        bp.narrow_decode(b[:, ::2], 3)
    with pytest.raises(ValueError, match="stride 1 in the last dimension"):
        bp.narrow_decode(b.view(2, 2, 3, 6)[:, :, :2, :3], 3)
    with pytest.raises(TypeError, match="uint8"):
        bp.narrow_decode(b.to(torch.int32), 3)
    with pytest.raises(ValueError, match="contiguous"):
        nat.natural_encode(torch.zeros((8, 6), device=dev).mT)
    with pytest.raises(ValueError, match="contiguous"):
        nat.natural_encode(torch.zeros((8, 6), device=dev)[:, ::2])
    # the encode's out and the bit unpack's input: no layout it cannot
    # address, no cast of a non-contiguous input
    idx = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="stride 1 in the last dimension"):
        bp.narrow_encode(idx, 3, out=b.as_strided((4, 6), (3, 1)))
    with pytest.raises(ValueError, match="narrow_encode out"):
        bp.narrow_encode(idx, 3, out=torch.empty((4, 6), dtype=torch.uint8))
    with pytest.raises(ValueError, match="stride 1 in the last dimension"):
        bp.unpack_bits(b[:, ::2])
    # natural_decode: no cast, no copy of a layout it cannot address
    code = torch.zeros((6, 16), dtype=torch.uint8, device=dev)
    sign = torch.zeros((6, 2), dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError, match="uint8"):
        bp.natural_decode(code.to(torch.int16), sign)
    with pytest.raises(ValueError, match="stride 1 in the last dimension"):
        bp.natural_decode(torch.zeros((6, 32), dtype=torch.uint8,
                                      device=dev)[:, ::2], sign)
    with pytest.raises(ValueError, match="stride 1 in the last dimension"):
        bp.natural_decode(code, torch.zeros((6, 4), dtype=torch.uint8,
                                            device=dev)[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        nat.to_bf16(torch.zeros((8, 6), device=dev).mT)


# --------------------------- narrow encode in place, two-stride rows, cast

def _narrow_encode_equal(x, width, out=None):
    bp.reset_launches()
    got = bp.narrow_encode(x, width, out=out)
    assert bp.LAUNCHES["narrow_encode"] == 1
    assert torch.equal(got.reshape(x.shape[:-1] + (-1,)),
                       bp.narrow_encode_ref(x, width))
    return got


def _idx(shape, width, seed, dev):
    hi = min(1 << (8 * width), 2**31)
    x = np.random.default_rng(seed).integers(0, hi, size=shape)
    x.reshape(-1)[0] = hi - 1
    return torch.from_numpy(x.astype(np.int32)).to(dev)


@pytest.mark.parametrize("rows,k", MAIN_NARROW + [(3, k) for k in
                                                  AROUND_VECTOR])
def test_narrow_encode_main_shapes_and_vector_edges(dev, rows, k):
    for width in (2, 3, 4):
        _narrow_encode_equal(_idx((rows, k), width, k, dev), width)


@pytest.mark.parametrize("rows,k", [(1, 9_000_001), (65_537, 5),
                                    (65_537, 4099)])
def test_narrow_encode_past_the_grid_limits(dev, rows, k):
    _narrow_encode_equal(_idx((rows, k), 3, 1, dev), 3)


@pytest.mark.parametrize("offset", range(1, 16))
def test_narrow_encode_at_storage_offsets(dev, offset):
    """int32 input 1-15 elements into a buffer (its groups of 4 start
    elsewhere in every row), into an output 1-15 bytes into a buffer (no
    plane is aligned); the bytes around the output stay."""
    for rows, k in ((3, 7), (2, 1003), (24, 4099)):
        x = _idx((rows * k + 16,), 3, offset, dev)[offset:offset + rows * k]
        buf = _bytes((rows * 3 * k + 32,), offset, dev)
        before = buf.clone()
        out = buf[offset:offset + rows * 3 * k].view(rows, 3 * k)
        _narrow_encode_equal(x.view(rows, k), 3, out=out)
        assert torch.equal(buf[:offset], before[:offset])
        assert torch.equal(buf[offset + rows * 3 * k:],
                           before[offset + rows * 3 * k:])


def _region_column(n_workers, n_stack, offset, n, pad, seed, dev):
    """The column ``[offset, offset + n)`` of a leaf's region ``[n_workers,
    n_stack, offset + n + pad]`` of a ``[n_workers, T]`` stage-like buffer
    with odd T: returns (buffer, column view)."""
    s_slice = offset + n + pad
    buf = _bytes((n_workers, n_stack * s_slice + 2 * pad + 1), seed, dev)
    col = buf[:, pad:pad + n_stack * s_slice].unflatten(
        1, (n_stack, s_slice))[:, :, offset:offset + n]
    return buf, col


@pytest.mark.parametrize("offset,pad", [(0, 1), (1, 0), (3, 7), (5, 13),
                                        (7, 2), (13, 9)])
@pytest.mark.parametrize("width", [2, 3, 4])
def test_narrow_encode_into_region_columns(dev, offset, pad, width):
    """Written in place at two row strides and odd byte offsets; every byte
    outside the column stays, and the decode reads the column back."""
    for n_workers, n_stack, k in ((2, 12, 58_983), (2, 3, 1003), (3, 1, 17)):
        buf, col = _region_column(n_workers, n_stack, offset, width * k, pad,
                                  offset + k, dev)
        before = buf.clone()
        x = _idx((n_workers, n_stack, k), width, k + width, dev)
        _narrow_encode_equal(x, width, out=col)
        mask = torch.ones_like(buf, dtype=torch.bool)
        mask[:, pad:pad + col.shape[1] * col.stride(1)].unflatten(
            1, (col.shape[1], col.stride(1)))[:, :, offset:offset
                                                 + width * k] = False
        assert torch.equal(buf[mask], before[mask])
        _decode_equal(col, width)
        assert torch.equal(bp.narrow_decode(col, width), x)


@pytest.mark.parametrize("offset,pad", [(1, 0), (3, 7), (13, 9)])
def test_unpack_bits_reads_region_columns(dev, offset, pad):
    for n_workers, n_stack, n in ((2, 12, 7_373), (2, 3, 129), (3, 1, 3)):
        _, col = _region_column(n_workers, n_stack, offset, n, pad, n, dev)
        bp.reset_launches()
        got = bp.unpack_bits(col)
        assert bp.LAUNCHES["unpack_bits"] == 1
        assert torch.equal(got, bp.unpack_bits_ref(col))


# ------------------- ragged pack_bits, unpack_bits and natural_decode rows

def _bits01(shape, seed, dev):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2, size=shape, dtype=np.uint8)).to(dev)


def _pack_equal(bits):
    bp.reset_launches()
    got = bp.pack_bits(bits)
    assert bp.LAUNCHES["pack_bits"] == 1
    assert torch.equal(got, bp.pack_bits_ref(bits))
    return got


def _unpack_equal(packed):
    bp.reset_launches()
    got = bp.unpack_bits(packed)
    assert bp.LAUNCHES["unpack_bits"] == 1
    assert torch.equal(got, bp.unpack_bits_ref(packed))


def _natural_decode_equal(codes, packed):
    bp.reset_launches()
    got = bp.natural_decode(codes, packed)
    assert bp.LAUNCHES["natural_decode"] == 1
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got.view(torch.int16),
                       bp.natural_decode_ref(codes, packed).view(torch.int16))


@pytest.mark.parametrize("rows,k", MAIN_NATURAL + [(3, 8 * 1003 + r)
                                                   for r in range(1, 8)])
def test_bit_rows_main_shapes_and_ragged_lengths(dev, rows, k):
    """The main path's Natural leaves (no row is whole bytes) and k mod 8
    = 1..7: packed, unpacked and decoded, each against its plain version."""
    packed = _pack_equal(_bits01((rows, k), k, dev))
    _unpack_equal(packed)
    _natural_decode_equal(_bytes((rows, k), k + 1, dev), packed)


@pytest.mark.parametrize("rows,k", [(65_537, 5), (70_000, 67),
                                    (1, 9_000_001)])
def test_bit_rows_past_the_grid_limits(dev, rows, k):
    """More rows than the grid's 65,535 in y (the kernels loop over rows),
    and one row longer than a grid row of blocks ever needs at once."""
    packed = _pack_equal(_bits01((rows, k), 3, dev))
    _unpack_equal(packed)
    _natural_decode_equal(_bytes((rows, k), 4, dev), packed)


@pytest.mark.parametrize("offset", range(1, 16))
def test_bit_rows_at_storage_offsets(dev, offset):
    """Every input 1-15 bytes into a larger buffer (the codes at another
    offset than the signs): no row is aligned."""
    for rows, k in ((3, 7), (2, 1003), (24, 58_983)):
        nb = (k + 7) // 8
        bits = _bits01((rows * k + 16,), offset, dev)
        _pack_equal(bits[offset:offset + rows * k].view(rows, k))
        signs = _bytes((rows * nb + 16,), offset, dev)
        packed = signs[offset:offset + rows * nb].view(rows, nb)
        _unpack_equal(packed)
        codes = _bytes((rows * k + 16,), offset + 1, dev)
        c0 = 16 - offset
        _natural_decode_equal(codes[c0:c0 + rows * k].view(rows, k), packed)


@pytest.mark.parametrize("offset,pad", [(0, 1), (1, 0), (3, 7), (5, 13),
                                        (7, 2), (13, 9)])
def test_bit_rows_on_region_columns(dev, offset, pad):
    """Sign planes, packed signs and codes as columns of leaf regions at
    two row strides and odd byte offsets, read in place; every buffer
    stays as it was."""
    for n_workers, n_stack, k in ((2, 12, 58_983), (2, 3, 1003), (3, 1, 17)):
        nb = (k + 7) // 8
        bbuf, bits = _region_column(n_workers, n_stack, offset, k, pad, k,
                                    dev)
        bbuf &= 1
        cbuf, codes = _region_column(n_workers, n_stack, offset, k, pad,
                                     k + 1, dev)
        sbuf, signs = _region_column(n_workers, n_stack, (offset + 5) % 16,
                                     nb, pad + 3, k + 2, dev)
        before = [b.clone() for b in (bbuf, cbuf, sbuf)]
        _pack_equal(bits)
        _unpack_equal(signs)
        _natural_decode_equal(codes, signs)
        _natural_decode_equal(codes.contiguous(), signs)
        _natural_decode_equal(codes, signs.contiguous())
        for b, was in zip((bbuf, cbuf, sbuf), before):
            assert torch.equal(b, was)


def test_natural_decompress_is_one_natural_decode_launch(dev):
    """On the card the decompress launches natural_decode once, neither
    unpack_bits nor a plain decode; a cast to f32 follows only where
    asked for."""
    x = torch.from_numpy(_natural_values((24, 58_983), 5)).to(dev).to(
        torch.bfloat16)
    bp.reset_launches()
    code, packed = ops.natural_compress(x)
    assert bp.LAUNCHES["pack_bits"] == 1
    want = ref.natural_decompress_ref(*ref.natural_compress_ref(x))
    for dtype in (torch.bfloat16, torch.float32):
        bp.reset_launches()
        got = ops.natural_decompress(code, packed, (2, 12, 58_983), dtype)
        assert {k: v for k, v in bp.LAUNCHES.items() if v} == {
            "natural_decode": 1}
        assert got.dtype == dtype and got.shape == (2, 12, 58_983)
        assert torch.equal(got.reshape(24, -1).to(torch.bfloat16).view(
            torch.int16), want.view(torch.int16))


NAN_BITS = [0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FFFFFFF,
            0xFFFFFFFF, 0x7FA00000, 0xFFA00000]


def _f32_bits(n, seed, dev):
    """Random f32 bit patterns over the whole range, the NaN patterns of
    both signs, +-inf, +-0, subnormals and rounding ties among them."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    special = np.array(NAN_BITS + [0x7F800000, 0xFF800000, 0, 0x80000000,
                                   1, 0x80000001, 0x00018000, 0x3F808000,
                                   0x3F818000, 0x7F7FFFFF], np.uint32)
    m = min(n, special.size)
    raw[:m] = special[:m]
    return torch.from_numpy(raw.view(np.float32)).to(dev)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 15, 16, 17, 1003, 9_000_001])
def test_to_bf16_bit_equal(dev, n):
    x = _f32_bits(n, n, dev)
    nat.reset_launches()
    got = nat.to_bf16(x)
    assert nat.LAUNCHES["to_bf16"] == 1
    assert torch.equal(got.view(torch.int16),
                       ref.to_bf16_ref(x).view(torch.int16))
    nan = torch.isnan(x)
    want = torch.where(torch.signbit(x[nan]), -64, 0x7FC0).to(torch.int16)
    assert torch.equal(got.view(torch.int16)[nan], want)


@pytest.mark.parametrize("offset", range(1, 8))
def test_to_bf16_at_storage_offsets(dev, offset):
    """Inputs not 16-byte aligned take the scalar loop."""
    x = _f32_bits(1003 + 8, offset, dev)[offset:offset + 1003]
    assert torch.equal(nat.to_bf16(x).view(torch.int16),
                       ref.to_bf16_ref(x).view(torch.int16))


def test_natural_encode_f32_nan_bits(dev):
    """Any f32 NaN: code 254 and the NaN's sign, as the plain version with
    the NaN rule (and the reference) give."""
    _encode_equal(_f32_bits(4099, 3, dev))
    code, sign = nat.natural_encode(_f32_bits(len(NAN_BITS), 3, dev))
    assert code.tolist() == [254] * len(NAN_BITS)
    assert sign.tolist() == [b >> 31 for b in NAN_BITS]


@pytest.mark.parametrize("w2s", ["top10", "top10+natural"])
def test_stage_buffers_packed_in_place_on_the_card(dev, w2s):
    """Reduced nanogpt's stage buffers packed on the card (codecs writing
    their columns in place) equal the plain path's on the CPU byte for
    byte; unpacked on the card they give the payloads back, the uint8
    leaves as views of the buffer."""
    from repro_torch.configs import get_config
    from repro_torch.dist.layerwise import LayerPlan
    from repro_torch.models.api import abstract_params, build_model
    from repro_torch.wire.codecs import (NarrowIntCodec, flatten_payload,
                                         unflatten_payload)

    def to_cpu(pl):
        names, leaves = flatten_payload(pl)
        return unflatten_payload(names, [t.cpu() for t in leaves])

    plan = LayerPlan.build(*abstract_params(build_model(
        get_config("nanogpt-124m").reduced())), w2s=w2s)
    sw = plan.staged_wire_layout(torch.bfloat16, plan.stage_plan())
    gen = torch.Generator(device=dev).manual_seed(0)
    pls = []
    for lp in plan.leaves:
        x = torch.randn((2,) + lp.shape, device=dev, generator=gen)
        if not getattr(lp.w2s, "lossless_wire", False):
            x = x.to(torch.bfloat16)
        pls.append(lp.w2s.compress({}, x, lp.slice_shape)[0])
    cpu = [to_cpu(p) for p in pls]
    bp.reset_launches()
    for k in range(sw.n_stages):
        buf = sw.pack_stage(k, pls)
        assert torch.equal(buf.cpu(), sw.pack_stage(k, cpu))
        for i, got in zip(sw.stage_leaf_ids[k], sw.unpack_stage(k, buf)):
            for a, b in zip(flatten_payload(got)[1],
                            flatten_payload(pls[i])[1]):
                assert a.dtype == b.dtype and torch.equal(a, b)
                if a.dtype == torch.uint8:
                    assert a.untyped_storage().data_ptr() == \
                        buf.untyped_storage().data_ptr()
    n_narrow = sum(isinstance(c, NarrowIntCodec)
                   for s in sw.base.specs for c in s.codecs)
    assert bp.LAUNCHES["narrow_encode"] == bp.LAUNCHES["narrow_decode"] \
        == n_narrow > 0


# ------------------------------------------------------------- RankK

def test_rank_compress_runs_the_kernels(dev):
    """RankK+Natural on the card: one NS chain of 5 iterations per call
    on the ``[L, r, m]`` sketches (10 ``ns_iteration`` and 5
    ``fused_matmul`` launches), Natural's kernels on both factors; the
    bf16 factors within one bf16 ulp of the leaf's largest magnitude of
    the CPU's (3xTF32 against f32: the two may round apart), the codes
    of equal factors bit-equal."""
    from repro_torch.core.compressors import RankK, WithNatural
    comp = WithNatural(RankK(fraction=0.1))
    state = comp.init(torch.Generator().manual_seed(0), (768, 3072),
                      torch.bfloat16, (2, 3))
    x = _t((2, 3, 768, 3072), 11, "cpu").to(torch.bfloat16)
    cuda_state = {"q": state["q"].to(dev)}
    reset_launches()
    nat.reset_launches()
    bp.reset_launches()
    fact_dev, st_dev = comp.inner.compress(cuda_state, x.to(dev),
                                           (768, 3072))
    assert LAUNCHES == {"ns_iteration": 10, "fused_matmul": 5}
    assert nat.LAUNCHES["to_bf16"] == 2
    fact_cpu, st_cpu = comp.inner.compress(state, x, (768, 3072))
    for k in ("p", "q"):
        a, b = fact_dev[k].cpu().float(), fact_cpu[k].float()
        assert a.shape == b.shape
        assert (a == b).float().mean().item() >= 0.95
        bound = 2.0 ** -8 * 2.0 ** np.ceil(np.log2(b.abs().max().item()))
        assert (a - b).abs().max().item() <= bound
    assert torch.equal(st_dev["q"].cpu(), fact_dev["q"].cpu())
    pl, _ = comp.compress(cuda_state, x.to(dev), (768, 3072))
    assert nat.LAUNCHES["natural_encode"] == bp.LAUNCHES["pack_bits"] == 2
    for k in ("p", "q"):
        rows = fact_dev[k].reshape(2, 3, -1)
        want_c, want_s = ref.natural_compress_ref(rows)
        assert torch.equal(pl[k + "_codes"], want_c)
        assert torch.equal(pl[k + "_signs"], bp.pack_bits_ref(want_s))
