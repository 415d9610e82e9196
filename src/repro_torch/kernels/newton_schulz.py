"""Hopper kernels for Newton-Schulz orthogonalisation (Muon's hot spot).

Port of the Pallas TPU kernels in ``repro/kernels/newton_schulz.py``;
the CUDA source, with the note on what bounds it on the card, is
``csrc/newton_schulz.cu``.

  * ``fused_matmul``: ``alpha * C + beta * (A @ op(B))`` over a batch,
    ``op`` identity or transpose — replaces ``_fused_matmul_kernel``.
  * ``syrk_upper``: ``beta * X @ X^T + alpha * C`` over a batch,
    computed on the upper tiles only and mirrored (exactly symmetric).
  * ``ns_iteration``: one quintic NS iteration over a ``[B, m, n]`` stack
    — replaces ``_ns_fused_kernel``. The [m, m] gram does not fit a
    block's shared memory on Hopper, so the iteration is three launches
    over a ``[B, m, m]`` f32 workspace: the gram ``G = X X^T`` and the
    poly ``P = c G G^T + b G`` by the symmetric kernel (``G`` is exactly
    symmetric, so ``G G^T = G G``), then the update ``X' = a X + P X`` by
    the ``fused_matmul`` kernel.

Both kernels compute their products on the tensor cores at f32 accuracy
(3xTF32, see the source's note). Each wrapper takes the plain version
(``ref.py``) for a tensor on the CPU, and for a CUDA tensor launches its
kernel or raises: it never falls back. ``LAUNCHES`` counts kernel
launches: ``ns_iteration`` one per launch of the symmetric kernel (two
per iteration; ``syrk_upper``'s included), ``fused_matmul`` one per GEMM
launch (one per iteration; the update inside ``ns_iteration`` included).
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import (NS_COEFFS, fused_matmul_ref, ns_iteration_batched_ref,
                  syrk_upper_ref)

TILE = 128             # output tile of both kernels (BM = BN in the source)
MAX_GRID_BATCH = 65535  # the batch rides a grid dimension
_I32 = 2**31 - 1

LAUNCHES = {"ns_iteration": 0, "fused_matmul": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("newton_schulz")
    if not getattr(lib, "_repro_typed", False):
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.ns_fused_matmul_f32.argtypes = [p, p, p, p, i, i, i, i, ll, ll,
                                            ll, ll, i, f, f, p]
        lib.ns_fused_matmul_f32.restype = i
        lib.ns_syrk_upper_f32.argtypes = [p, p, p, i, i, i, ll, ll, ll, f, f,
                                          p]
        lib.ns_syrk_upper_f32.restype = i
        lib._repro_typed = True
    return lib


def _check_cuda(name: str, t: torch.Tensor, ndim: int,
                device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if any(s > _I32 for s in t.shape):
        raise ValueError(f"{name} dims exceed int32: {tuple(t.shape)}")


def _launch_fused_matmul(a, b, c, out, trans_b: bool, alpha: float,
                         beta: float) -> None:
    bsz, m, k = a.shape
    n = b.shape[1] if trans_b else b.shape[2]
    rc = _lib().ns_fused_matmul_f32(
        a.data_ptr(), b.data_ptr(), None if c is None else c.data_ptr(),
        out.data_ptr(), bsz, m, n, k, m * k, b.shape[1] * b.shape[2],
        m * n, m * n, int(trans_b), float(alpha), float(beta),
        build.stream(a.device))
    build.check_launch(rc, "fused_matmul")
    LAUNCHES["fused_matmul"] += 1


def _launch_syrk_upper(x, c, out, alpha: float, beta: float) -> None:
    bsz, m, k = x.shape
    rc = _lib().ns_syrk_upper_f32(
        x.data_ptr(), None if c is None else c.data_ptr(), out.data_ptr(),
        bsz, m, k, m * k, m * m, m * m, float(alpha), float(beta),
        build.stream(x.device))
    build.check_launch(rc, "syrk_upper")
    LAUNCHES["ns_iteration"] += 1


def _batch_ok(bsz: int) -> None:
    if not 0 < bsz <= MAX_GRID_BATCH:
        raise ValueError(f"batch {bsz} outside [1, {MAX_GRID_BATCH}]")


def fused_matmul(a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor | None = None, alpha: float = 1.0,
                 beta: float = 1.0, trans_b: bool = False) -> torch.Tensor:
    """``alpha * c + beta * (a @ op(b))`` in f32, ``op(b) = b.mT`` when
    ``trans_b``. ``a`` is ``[M, K]`` or ``[B, M, K]``; ``b`` and ``c``
    match its batch. Ragged shapes are fine: the kernel masks its edges."""
    if a.device.type == "cpu":
        return fused_matmul_ref(a, b.mT if trans_b else b, c, alpha, beta)
    if a.device.type != "cuda":
        raise ValueError(f"fused_matmul runs on cpu or cuda, not {a.device}")
    ndim = a.ndim
    if ndim not in (2, 3):
        raise ValueError(f"a must be 2-D or 3-D, got {tuple(a.shape)}")
    for name, t in (("a", a), ("b", b)) + ((("c", c),) if c is not None
                                           else ()):
        _check_cuda(name, t, ndim, a.device)
    a3, b3 = (a, b) if ndim == 3 else (a[None], b[None])
    c3 = None if c is None else (c if ndim == 3 else c[None])
    bsz, m, k = a3.shape
    kb, n = (b3.shape[2], b3.shape[1]) if trans_b else b3.shape[1:]
    if b3.shape[0] != bsz or kb != k:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, trans_b={trans_b}")
    if c3 is not None and tuple(c3.shape) != (bsz, m, n):
        raise ValueError(f"c must be {(bsz, m, n)}, got {tuple(c.shape)}")
    _batch_ok(bsz)
    out = torch.empty((bsz, m, n), dtype=torch.float32, device=a.device)
    if m and n:
        with torch.cuda.device(a.device):
            _launch_fused_matmul(a3, b3, c3, out, trans_b, alpha, beta)
    return out if ndim == 3 else out[0]


def syrk_upper(x: torch.Tensor, c: torch.Tensor | None = None,
               alpha: float = 1.0, beta: float = 1.0) -> torch.Tensor:
    """``beta * x @ x.mT + alpha * c`` in f32 over ``[M, K]`` or
    ``[B, M, K]``, computed on the upper triangle and mirrored: the result
    is exactly symmetric and ``c`` is read on its upper triangle only (it
    equals the formula when ``c`` is symmetric). Ragged shapes are fine."""
    if x.device.type == "cpu":
        return syrk_upper_ref(x, c, alpha, beta)
    if x.device.type != "cuda":
        raise ValueError(f"syrk_upper runs on cpu or cuda, not {x.device}")
    ndim = x.ndim
    if ndim not in (2, 3):
        raise ValueError(f"x must be 2-D or 3-D, got {tuple(x.shape)}")
    _check_cuda("x", x, ndim, x.device)
    x3 = x if ndim == 3 else x[None]
    bsz, m, _ = x3.shape
    c3 = None
    if c is not None:
        _check_cuda("c", c, ndim, x.device)
        c3 = c if ndim == 3 else c[None]
        if tuple(c3.shape) != (bsz, m, m):
            raise ValueError(f"c must be {(bsz, m, m)}, got "
                             f"{tuple(c.shape)}")
    _batch_ok(bsz)
    out = torch.empty((bsz, m, m), dtype=torch.float32, device=x.device)
    if m:
        with torch.cuda.device(x.device):
            _launch_syrk_upper(x3, c3, out, alpha, beta)
    return out if ndim == 3 else out[0]


def ns_iteration(x: torch.Tensor, coeffs=NS_COEFFS) -> torch.Tensor:
    """One quintic NS iteration X' = aX + (bA + cA^2)X, A = XX^T, over a
    ``[B, m, n]`` f32 stack. On the card: three launches (gram, poly,
    update) over a ``[B, m, m]`` f32 gram and poly workspace
    (``2 * 4 * B * m^2`` bytes, see ``ns_workspace_bytes``)."""
    if x.device.type == "cpu":
        return ns_iteration_batched_ref(x, coeffs)
    if x.device.type != "cuda":
        raise ValueError(f"ns_iteration runs on cpu or cuda, not {x.device}")
    _check_cuda("x", x, 3, x.device)
    bsz, m, n = x.shape
    _batch_ok(bsz)
    a, b, c = coeffs
    if m == 0 or n == 0:
        return torch.empty_like(x)
    gram = torch.empty((bsz, m, m), dtype=torch.float32, device=x.device)
    poly = torch.empty_like(gram)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch_syrk_upper(x, None, gram, 1.0, 1.0)
        _launch_syrk_upper(gram, gram, poly, b, c)
        _launch_fused_matmul(poly, x, x, out, False, a, 1.0)
    return out


def ns_workspace_bytes(bsz: int, m: int) -> int:
    """Device bytes of the gram + poly workspace of one ``ns_iteration``
    over ``[bsz, m, n]``."""
    return 2 * 4 * bsz * m * m
