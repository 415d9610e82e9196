"""Hopper kernel for Natural compression encode (Horvath et al. 2022).

Port of the Pallas TPU kernel in ``repro/kernels/natural_pack.py``; the
CUDA source, with the note on what bounds it on the card, is
``csrc/natural_pack.cu``. Every value, cast to bf16 with round-to-nearest-
even, is rounded to the nearest power of two and emitted as an (exponent
code, sign) pair of uint8 planes of the input's shape; ``ref.py`` holds
the plain version (``natural_compress_ref``). The 8:1 packing of the sign
plane (9 bits per value on the wire) is ``bitpack.pack_bits``, called by
``ops.natural_compress``; the decode is ``bitpack.natural_decode``.

``to_bf16`` is the f32 -> bf16 cast with XLA's bits (every NaN to ``sign
| 0x7FC0``) that the EF21 difference takes on its way to the wire, as a
kernel of the same source; ``ref.to_bf16_ref`` is its plain version.

Each wrapper takes the plain version for a tensor on the CPU (or the
``meta`` device), and for a CUDA tensor launches its kernel or raises.
``LAUNCHES`` counts their launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .bitpack import check_input, plain_device
from .ref import natural_compress_ref, to_bf16_ref

LAUNCHES = {"natural_encode": 0, "to_bf16": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("natural_pack")
    if not getattr(lib, "_repro_typed", False):
        p = ctypes.c_void_p
        lib.nat_encode.argtypes = [p, ctypes.c_int, p, p, ctypes.c_longlong,
                                   p]
        lib.nat_encode.restype = ctypes.c_int
        lib.nat_to_bf16.argtypes = [p, p, ctypes.c_longlong, p]
        lib.nat_to_bf16.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def natural_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 or bf16 ``[*lead, n]`` -> (uint8 codes, uint8 signs in {0,1}),
    both of ``x``'s shape."""
    if plain_device(x, "natural_encode"):
        return natural_compress_ref(x)
    check_input("natural_encode", x, (torch.float32, torch.bfloat16))
    code = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    sign = torch.empty_like(code)
    if x.numel():
        with torch.cuda.device(x.device):
            build.check_launch(_lib().nat_encode(
                x.data_ptr(), int(x.dtype == torch.bfloat16),
                code.data_ptr(), sign.data_ptr(), x.numel(),
                build.stream(x.device)), "natural_encode")
        LAUNCHES["natural_encode"] += 1
    return code, sign


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 with XLA's bits: round to nearest even, every NaN to
    ``sign | 0x7FC0``; bf16 passes through (``ref.to_bf16_ref``)."""
    if plain_device(x, "to_bf16") or x.dtype != torch.float32:
        return to_bf16_ref(x)       # bf16 passes, any other dtype raises
    if not x.is_contiguous():
        raise ValueError("to_bf16 input must be contiguous")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    if x.numel():
        with torch.cuda.device(x.device):
            build.check_launch(_lib().nat_to_bf16(
                x.data_ptr(), out.data_ptr(), x.numel(),
                build.stream(x.device)), "to_bf16")
        LAUNCHES["to_bf16"] += 1
    return out
