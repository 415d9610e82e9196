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
``add_f32`` and ``fold_f32`` are the f32 adds of the estimates and of the
server's fold with XLA's NaN rule (a NaN operand keeps its payload,
quieted), also of that source; ``ref.add_f32_ref`` and
``ref.fold_f32_ref`` are their plain versions.

Each wrapper takes the plain version for a tensor on the CPU (or the
``meta`` device), and for a CUDA tensor launches its kernel or raises.
``LAUNCHES`` counts their launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .bitpack import check_input, plain_device
from .ref import (add_f32_ref, fold_f32_ref, natural_compress_ref,
                  to_bf16_ref)

LAUNCHES = {"natural_encode": 0, "to_bf16": 0, "add_f32": 0,
            "fold_f32": 0}


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
        lib.nat_add_f32.argtypes = [p, p, p, ctypes.c_longlong,
                                    ctypes.c_longlong, ctypes.c_longlong,
                                    p]
        lib.nat_add_f32.restype = ctypes.c_int
        lib.nat_fold_f32.argtypes = [p, p, p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_float, p, p]
        lib.nat_fold_f32.restype = ctypes.c_int
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


def _check_f32(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous")


def add_f32(a: torch.Tensor, b: torch.Tensor,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """``a + b`` in f32 with XLA's NaN rule (``ref.add_f32_ref``): ``a``'s
    NaN quieted, else ``b``'s, else the IEEE sum. An operand may lack
    leading dims of the other (it is repeated over them, as PyTorch
    broadcasts). Written into ``out`` where given (``a`` or ``b`` itself:
    in place), else into a new tensor."""
    if plain_device(a, "add_f32"):
        r = add_f32_ref(a, b)
        return r if out is None else out.copy_(r)
    _check_f32("add_f32", a, b)
    shape = a.shape if a.ndim >= b.ndim else b.shape
    if b.device != a.device or any(t.shape != shape[len(shape) - t.ndim:]
                                   for t in (a, b)):
        raise ValueError(f"add_f32 operands {tuple(a.shape)} on {a.device} "
                         f"and {tuple(b.shape)} on {b.device}")
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=a.device)
    _check_f32("add_f32", out)
    if out.shape != shape:
        raise ValueError(f"add_f32 writes {tuple(shape)}, out is "
                         f"{tuple(out.shape)}")
    if out.numel():
        with torch.cuda.device(a.device):
            build.check_launch(_lib().nat_add_f32(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), out.numel(),
                a.numel(), b.numel(), build.stream(a.device)), "add_f32")
        LAUNCHES["add_f32"] += 1
    return out


def fold_f32(g: torch.Tensor, d: torch.Tensor, count: int | torch.Tensor,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """The server's fold ``g + (sum_j d_j) / count`` over ``d``'s worker
    lead (``[n, *g.shape]``), f32, with XLA's NaN rule at every operation
    (``ref.fold_f32_ref``): an int ``count`` is ``jnp.mean``'s n, a 0-d
    f32 tensor on ``g``'s device the elastic arm's dynamic count. Written
    into ``out`` where given (``g`` itself: in place)."""
    if plain_device(g, "fold_f32"):
        r = fold_f32_ref(g, d, count)
        return r if out is None else out.copy_(r)
    _check_f32("fold_f32", g, d)
    if d.ndim != g.ndim + 1 or d.shape[1:] != g.shape or d.shape[0] < 1 \
            or d.device != g.device:
        raise ValueError(f"fold_f32 takes d [n, *{tuple(g.shape)}] on "
                         f"{g.device}, got {tuple(d.shape)} on {d.device}")
    if out is None:
        out = torch.empty_like(g)
    _check_f32("fold_f32", out)
    if isinstance(count, torch.Tensor):
        if count.dtype != torch.float32 or count.numel() != 1 \
                or count.device != g.device:
            raise ValueError("fold_f32's count tensor must be one f32 on "
                             f"{g.device}, got {count.dtype} "
                             f"{tuple(count.shape)} on {count.device}")
        recip, count_ptr = 0.0, count.data_ptr()
    else:
        recip = float(torch.tensor(1.0, dtype=torch.float32) / int(count))
        count_ptr = None
    if g.numel():
        with torch.cuda.device(g.device):
            build.check_launch(_lib().nat_fold_f32(
                g.data_ptr(), d.data_ptr(), out.data_ptr(), g.numel(),
                d.shape[0], recip, count_ptr, build.stream(g.device)),
                "fold_f32")
        LAUNCHES["fold_f32"] += 1
    return out
