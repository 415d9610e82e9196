"""Hopper kernels for the wire's bit-packing primitives (``repro_torch.wire``).

Port of the Pallas TPU kernels in ``repro/kernels/bitpack.py``; the CUDA
source, with the note on what bounds it on the card, is
``csrc/bitpack.cu``. Two bit-exact pairs, each with its plain PyTorch
version beside it:

  * ``pack_bits`` / ``unpack_bits``: 1-bit planes (Natural's sign
    bitmaps), 8 consecutive {0,1} bytes -> one byte, LSB first; a row of
    any length n packs to ceil(n/8) bytes, the bits past n zero (the
    reference pads each slice with zeros before packing it);
  * ``narrow_encode`` / ``narrow_decode``: int32 indices whose domain
    fits 2 (uint16) or 3 (uint24) bytes as ``width`` byte planes,
    plane-major and little-endian (plane i holds byte i of every index).

``natural_decode`` is Natural's decode, codes and packed signs -> bf16:
on the card the ``unpack_bits`` kernel's body with another epilogue, so
the {0,1} sign plane never reaches memory.

Every function works on a batch of rows, ``[*lead, n]``: each row is one
message (a worker's stack slice), packed on its own, so the planes of
``narrow_encode`` are plane-major *within* each row. One launch covers a
whole parameter leaf. On the card ``narrow_encode`` writes its rows, and
the other kernels read theirs, where they lie in a wire stage buffer: a
codec's column of a leaf's region, ``[n_workers, *stack, nbytes]`` at
any byte offset (``_row_strides``).

Each wrapper takes the plain version for a tensor on the CPU (or the
``meta`` device, where the wire layout derives payload shapes), and for
a CUDA tensor launches its kernel or raises: it never falls back.
``LAUNCHES`` counts kernel launches by wrapper.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import build
from .ref import natural_decompress_ref

LAUNCHES = {"narrow_encode": 0, "narrow_decode": 0, "pack_bits": 0,
            "unpack_bits": 0, "natural_decode": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain versions

def narrow_width(domain: int) -> int:
    """Smallest byte width in {2, 3, 4} that indexes [0, domain)."""
    if domain <= 1 << 16:
        return 2
    if domain <= 1 << 24:
        return 3
    return 4


def narrow_encode_ref(idx: torch.Tensor, width: int) -> torch.Tensor:
    """int32 ``[*lead, k]`` in [0, 2^(8*width)) -> uint8
    ``[*lead, width*k]``, plane-major little-endian within each row."""
    shifts = torch.arange(width, dtype=torch.int32, device=idx.device) * 8
    planes = (idx.to(torch.int32)[..., None, :] >> shifts[:, None]) & 0xFF
    return planes.to(torch.uint8).reshape(
        idx.shape[:-1] + (width * idx.shape[-1],))


def narrow_decode_ref(b: torch.Tensor, width: int) -> torch.Tensor:
    """uint8 ``[*lead, width*k]`` plane-major -> int32 ``[*lead, k]``."""
    planes = b.reshape(b.shape[:-1] + (width, -1)).to(torch.int32)
    out = planes[..., 0, :]
    for p in range(1, width):
        out = out | (planes[..., p, :] << (8 * p))
    return out


def pack_bits_ref(bits01: torch.Tensor) -> torch.Tensor:
    """uint8 ``[*lead, n]`` of {0,1} -> uint8 ``[*lead, ceil(n/8)]``, LSB
    first: each row padded with zeros to whole bytes, then byte e = sum_l
    bits[8e + l] << l (bit 0 of each input byte)."""
    b = F.pad(bits01, (0, (-bits01.shape[-1]) % 8))
    b = (b.reshape(b.shape[:-1] + (-1, 8)) & 1).to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=b.device)
    return torch.sum(b << shifts, dim=-1).to(torch.uint8)


def unpack_bits_ref(packed: torch.Tensor) -> torch.Tensor:
    """uint8 ``[*lead, k]`` -> uint8 ``[*lead, 8k]`` of {0,1} (inverse
    of ``pack_bits_ref``)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (8 * packed.shape[-1],))


def natural_decode_ref(code: torch.Tensor,
                       packed_sign: torch.Tensor) -> torch.Tensor:
    """Codes uint8 ``[*lead, k]`` and packed signs uint8 ``[*lead,
    ceil(k/8)]`` -> bf16 ``[*lead, k]`` (``ref.natural_decompress_ref`` of
    the unpacked signs)."""
    sign = unpack_bits_ref(packed_sign)[..., :code.shape[-1]]
    return natural_decompress_ref(code, sign)


# ------------------------------------------------------------------ kernels

def _lib() -> ctypes.CDLL:
    lib = build.load("bitpack")
    if not getattr(lib, "_repro_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bp_narrow_encode.argtypes = [p, p, ll, ll, ll, ll, ll, i, p]
        lib.bp_narrow_decode.argtypes = [p, ll, ll, ll, ll, p, ll, i, p]
        lib.bp_pack_bits.argtypes = [p, ll, ll, ll, ll, p, ll, p]
        lib.bp_unpack_bits.argtypes = [p, ll, ll, ll, ll, p, ll, p]
        lib.bp_natural_decode.argtypes = [p, ll, ll, p, ll, ll, ll, ll, p,
                                          ll, p]
        for fn in (lib.bp_narrow_encode, lib.bp_narrow_decode,
                   lib.bp_pack_bits, lib.bp_unpack_bits,
                   lib.bp_natural_decode):
            fn.restype = i
        lib._repro_typed = True
    return lib


def plain_device(t: torch.Tensor, name: str) -> bool:
    """True where a wrapper takes its plain version (CPU and meta
    tensors); False for CUDA; raises for any other device."""
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return False


def check_input(name: str, t: torch.Tensor, dtypes: tuple) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} takes {', '.join(map(str, dtypes))}, got "
                        f"{t.dtype}")
    if t.ndim == 0:
        raise ValueError(f"{name} takes [*lead, n], got a scalar")
    if not t.is_contiguous():
        raise ValueError(f"{name} input must be contiguous")


def _rows(t: torch.Tensor) -> int:
    return math.prod(t.shape[:-1])


def _check_width(width: int) -> None:
    if width not in (2, 3, 4):
        raise ValueError(f"width must be 2, 3 or 4, got {width}")


def _row_strides(t: torch.Tensor, name: str) -> tuple[int, int, int, int]:
    """``(n_workers, n_stack, s_worker, s_slice)`` of a ``[*lead, n]``
    tensor that a kernel reads or writes in place: its ``prod(lead) =
    n_workers * n_stack`` rows, row ``w * n_stack + j`` starting ``w *
    s_worker + j * s_slice`` elements after its first. Takes a contiguous
    tensor, or a view with stride 1 in the last dimension whose leading
    dimensions fold into ``[W, S]`` at two strides with no two rows
    overlapping (a codec's column of a leaf's region of a wire stage
    buffer, ``[n_workers, *stack, nbytes]``, at any byte offset); raises
    for any other."""
    n = t.shape[-1]
    if t.is_contiguous():
        return min(1, _rows(t)), _rows(t), 0, n
    dims = [(size, st) for size, st in zip(t.shape[:-1], t.stride()[:-1])
            if size != 1]
    ok = bool(dims) and (t.stride(-1) == 1 or n == 1)
    if ok:
        w, s_worker = dims[0] if len(dims) > 1 else (1, 0)
        inner = dims[1:] if len(dims) > 1 else dims
        ok = all(sa == sb * b for (_, sa), (b, sb) in zip(inner, inner[1:]))
        n_stack, s_slice = math.prod(d for d, _ in inner), inner[-1][1]
        ok = ok and (n_stack == 1 or s_slice >= n) and (
            w == 1 or s_worker >= (n_stack - 1) * s_slice + n)
    if not ok:
        raise ValueError(
            f"{name} takes a contiguous tensor or a view with stride 1 in "
            "the last dimension whose leading dimensions fold into two "
            "strides, rows not overlapping; got shape "
            f"{tuple(t.shape)}, strides {t.stride()}")
    return w, n_stack, s_worker, s_slice


def narrow_encode(idx: torch.Tensor, width: int,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """int32 ``[*lead, k]`` in [0, 2^(8*width)) -> uint8
    ``[*lead, width*k]``, plane-major little-endian within each row.
    Bit-exact pair with ``narrow_decode``; width 4 round-trips any
    non-negative int32.

    ``out``, if given, is a uint8 ``[*lead', width*k]`` with as many rows,
    written in place and returned: on the card the kernel writes each row
    where it lies (``_row_strides``: a codec's column of a wire stage
    buffer), and raises for a layout it cannot address; elsewhere the plain
    version's bytes are copied in."""
    _check_width(width)
    if out is not None and (
            out.dtype != torch.uint8 or out.device != idx.device
            or idx.ndim == 0 or out.ndim == 0
            or out.shape[-1] != width * idx.shape[-1]
            or _rows(out) != _rows(idx)):
        raise ValueError(
            f"narrow_encode out must be uint8 [*lead, {width} * k] with the "
            f"input's rows, on its device; got {out.dtype} "
            f"{tuple(out.shape)} on {out.device} for {idx.dtype} "
            f"{tuple(idx.shape)} on {idx.device}")
    if plain_device(idx, "narrow_encode"):
        enc = narrow_encode_ref(idx, width)
        return enc if out is None else out.copy_(enc.reshape(out.shape))
    check_input("narrow_encode", idx, (torch.int32,))
    k = idx.shape[-1]
    if out is None:
        out = torch.empty(idx.shape[:-1] + (width * k,), dtype=torch.uint8,
                          device=idx.device)
    rows = _row_strides(out, "narrow_encode")
    if out.numel():
        with torch.cuda.device(idx.device):
            build.check_launch(_lib().bp_narrow_encode(
                idx.data_ptr(), out.data_ptr(), *rows, k, width,
                build.stream(idx.device)), "narrow_encode")
        LAUNCHES["narrow_encode"] += 1
    return out


def narrow_decode(b: torch.Tensor, width: int) -> torch.Tensor:
    """uint8 ``[*lead, width*k]`` plane-major -> int32 ``[*lead, k]``.

    On the card the input is read in place (``_row_strides``): the wire's
    codec hands it its column of a stage buffer without copying it."""
    _check_width(width)
    if b.ndim == 0 or b.shape[-1] % width:
        raise ValueError(f"last dim of {tuple(b.shape)} is not a multiple "
                         f"of width {width}")
    if plain_device(b, "narrow_decode"):
        return narrow_decode_ref(b, width)
    if b.dtype != torch.uint8:
        raise TypeError(f"narrow_decode takes torch.uint8, got {b.dtype}")
    rows = _row_strides(b, "narrow_decode")
    k = b.shape[-1] // width
    out = torch.empty(b.shape[:-1] + (k,), dtype=torch.int32,
                      device=b.device)
    if out.numel():
        with torch.cuda.device(b.device):
            build.check_launch(_lib().bp_narrow_decode(
                b.data_ptr(), *rows, out.data_ptr(), k, width,
                build.stream(b.device)), "narrow_decode")
        LAUNCHES["narrow_decode"] += 1
    return out


def pack_bits(bits01: torch.Tensor) -> torch.Tensor:
    """uint8 ``[*lead, n]`` of {0,1}, any n -> uint8 ``[*lead, ceil(n/8)]``,
    LSB first, the bits past n in each row's last byte zero (bit-exact pair
    with ``unpack_bits``). On the card the input rows are read where they
    lie (``_row_strides``): the sign plane of ``natural_encode`` with rows
    at any byte alignment, with no padded copy."""
    if bits01.ndim == 0:
        raise ValueError("pack_bits takes [*lead, n], got a scalar")
    if plain_device(bits01, "pack_bits"):
        return pack_bits_ref(bits01)
    if bits01.dtype != torch.uint8:
        raise TypeError(f"pack_bits takes torch.uint8, got {bits01.dtype}")
    rows = _row_strides(bits01, "pack_bits")
    n = bits01.shape[-1]
    out = torch.empty(bits01.shape[:-1] + (-(-n // 8),), dtype=torch.uint8,
                      device=bits01.device)
    if out.numel():
        with torch.cuda.device(bits01.device):
            build.check_launch(_lib().bp_pack_bits(
                bits01.data_ptr(), *rows, out.data_ptr(), n,
                build.stream(bits01.device)), "pack_bits")
        LAUNCHES["pack_bits"] += 1
    return out


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """uint8 ``[*lead, k]`` -> uint8 ``[*lead, 8k]`` of {0,1} (inverse
    of ``pack_bits``). On the card the input is read in place
    (``_row_strides``)."""
    if plain_device(packed, "unpack_bits"):
        return unpack_bits_ref(packed)
    if packed.dtype != torch.uint8:
        raise TypeError(f"unpack_bits takes torch.uint8, got {packed.dtype}")
    if packed.ndim == 0:
        raise ValueError("unpack_bits takes [*lead, n], got a scalar")
    rows = _row_strides(packed, "unpack_bits")
    out = torch.empty(packed.shape[:-1] + (8 * packed.shape[-1],),
                      dtype=torch.uint8, device=packed.device)
    if out.numel():
        with torch.cuda.device(packed.device):
            build.check_launch(_lib().bp_unpack_bits(
                packed.data_ptr(), *rows, out.data_ptr(), packed.shape[-1],
                build.stream(packed.device)), "unpack_bits")
        LAUNCHES["unpack_bits"] += 1
    return out


def _decode_row_strides(code: torch.Tensor, packed_sign: torch.Tensor):
    """``_row_strides`` of ``natural_decode``'s two operands over one row
    folding ``(n_workers, n_stack)``: two views of one lead shape fold
    alike, and a contiguous operand (rows at ``r * n``) takes the other's
    folding."""
    rc = _row_strides(code, "natural_decode")
    rs = _row_strides(packed_sign, "natural_decode")
    if packed_sign.is_contiguous():
        rs = rc[:2] + (rc[1] * rs[3], rs[3])
    elif code.is_contiguous():
        rc = rs[:2] + (rs[1] * rc[3], rc[3])
    return rc, rs


def natural_decode(code: torch.Tensor,
                   packed_sign: torch.Tensor) -> torch.Tensor:
    """Natural's decode: codes uint8 ``[*lead, k]`` and packed signs uint8
    ``[*lead, ceil(k/8)]`` -> bf16 ``[*lead, k]``, the bits ``(code << 7) -
    (sign << 15)`` (``natural_decode_ref``). On the card both inputs are
    read in place, each at its own row strides (``_row_strides``: the
    ``*_codes`` and ``*_signs`` columns of a wire stage buffer), by the
    ``unpack_bits`` body with a Natural epilogue that writes each value
    once."""
    if code.ndim == 0 or packed_sign.shape[:-1] != code.shape[:-1] \
            or packed_sign.shape[-1] != -(-code.shape[-1] // 8):
        raise ValueError(
            f"natural_decode takes codes [*lead, k] and signs [*lead, "
            f"ceil(k/8)]; got {tuple(code.shape)} and "
            f"{tuple(packed_sign.shape)}")
    if code.device != packed_sign.device:
        raise ValueError(f"natural_decode: codes on {code.device}, signs on "
                         f"{packed_sign.device}")
    if plain_device(code, "natural_decode"):
        return natural_decode_ref(code, packed_sign)
    if code.dtype != torch.uint8 or packed_sign.dtype != torch.uint8:
        raise TypeError(f"natural_decode takes torch.uint8, got "
                        f"{code.dtype} and {packed_sign.dtype}")
    k = code.shape[-1]
    rc, rs = _decode_row_strides(code, packed_sign)
    out = torch.empty(code.shape, dtype=torch.bfloat16, device=code.device)
    if out.numel():
        with torch.cuda.device(code.device):
            build.check_launch(_lib().bp_natural_decode(
                code.data_ptr(), rc[2], rc[3], packed_sign.data_ptr(),
                rs[2], rs[3], rc[0], rc[1], out.data_ptr(), k,
                build.stream(code.device)), "natural_decode")
        LAUNCHES["natural_decode"] += 1
    return out
