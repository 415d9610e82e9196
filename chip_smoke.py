#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the repository around this file; exits non-zero
without printing a result otherwise. In order, any failure ending the run:

  1. prints the card's name and power limit as ``nvidia-smi`` gives them;
  2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, timed;
  3. holds each kernel against its plain PyTorch version on the card, at
     the shapes of nanogpt-124m's two Newton-Schulz buckets ([48,768,768]
     and [24,768,3072]), on inputs whose entries span ~2^20 in magnitude,
     and at ragged shapes (rows not 16-byte aligned among them), with the
     tolerances below, and times kernel, plain version and a cuBLAS
     yardstick (f32, TF32 off) with CUDA events;
     Then holds the wire's kernels (narrow encode/decode, bit
     pack/unpack, Natural encode and decode) and the f32 -> bf16 cast
     with XLA's NaN bits bit for bit against their plain versions at the
     row shapes of nanogpt-124m's packed wire (Natural's sign rows of
     any length, as ``natural_encode`` gives them) plus ragged ones (f32
     NaNs of both signs, +-inf and +-0 among Natural's inputs), on
     inputs and outputs 1-15 elements into a larger buffer, more rows
     than a grid's 65,535, the narrow encode and decode, the bit pack and
     unpack and the Natural decode on the columns of leaf regions of
     wider buffers (two row strides, odd byte offsets), the packed top10
     stage buffers packed in place on the card against the plain path's
     on the CPU, then decoded in place, the Natural decode in place on
     the top10+natural stage buffers, and the natural arm's whole-slice
     rows; timed the same way, beside the copies the in-place wire no
     longer makes, the sign pads and the eager decode chain the Natural
     path no longer runs, and the cast's time against PyTorch's own
     cast;
  4. drives the port's train CLI on nanogpt-124m at full width (12
     layers, d_model 768) for 4 steps on the card — 2 workers, top10
     w2s, seq 1024, batch 8 — and checks that the losses are finite and
     that the Newton-Schulz kernels were launched exactly steps x ns_steps
     x buckets x 3 times (2 symmetric, 1 GEMM); before that, a reduced
     nanogpt run on the card
     must track the same run on the CPU (plain versions);
  5. the packed wire: the same run through a Trainer over a one-rank
     NCCL group, so phase 4 packs each wire stage into a uint8 buffer and
     all-gathers it — first step 0's payloads through pack -> gather ->
     unpack, bit for bit; then 4 steps with top10 (losses near the
     unpacked run's) and 4 with top10+natural, each checking the
     gathers against the trainer's wire budget and the wire kernels'
     launches against what the layout implies;
  6. prints one JSON line of per-kernel numbers, then, as the last line,
     {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W):
F32_FLOPS = 67e12        # f32 outside the tensor cores (FFMA)
TF32_FLOPS = 495e12      # TF32 tensor cores, dense
HBM_BYTES_S = 3.35e12
# The NS kernels' route: f32-accurate products as three TF32 products
# (3xTF32), so their bound is the TF32 peak over 3.
NS_FLOPS = TF32_FLOPS / 3
NS_DESIGN = ("3xTF32 wgmma m64n128k8 from shared memory, 3-stage cp.async "
             "ring, symmetric poly")
# 32-bit integer operations: 64 INT32 lanes per SM per clock (half the
# FP32 lanes; Hopper white paper) x 132 SMs x 1.98 GHz boost
INT32_OPS_S = 64 * 132 * 1.98e9

# Tolerances, as max|kernel - plain| / max|plain| on the card. The plain
# side is cuBLAS in true f32; the kernels take f32-accurate products on
# the tensor cores (3xTF32: ~2^-22 residual per product, each 64-deep
# span of K summed apart and added in f32), so the two differ by that
# residual and by summation order over K <= 3072 terms (f32 eps 1.2e-7;
# a worst-case bound is ~K eps). One-pass TF32 misses TOL_ONE_PASS
# (tests/test_torch_ns_precision.py).
TOL_ONE_PASS = 1e-5      # one GEMM / one NS iteration
TOL_NS_CHAIN = 1e-4      # 5 chained NS iterations amplify the difference
TOL_SLICE_LOSS = 1e-3    # reduced nanogpt, 3 steps, card vs CPU (abs)
# Packed vs unpacked full-width run: the wire is bit-exact, so the two
# can differ only where the backward pass is not deterministic on the card
# (atomic adds), where a flipped bf16 TopK tie then moves a step (abs, 4
# steps). Measured on an H100: 0.0, the two runs' losses bit-equal.
TOL_PACKED_LOSS = 1e-2

# exact u8 bytes per worker of nanogpt-124m's wire (the CPU tests pin them)
WIRE_BYTES = {"top10": 66_194_428, "top10+natural": 55_313_394}
WIRE_DESIGN = {
    "narrow_encode": "2-D grid (row, chunk of 4096), 16 elements a thread "
                     "as 4 int4 loads in flight, byte_perm transpose into "
                     "each plane's span in shared memory, stored as "
                     "aligned 16-byte words (funnel shift), rows written in "
                     "place at two strides",
    "natural_encode": "8 elements a thread (one 16-byte bf16 load, two "
                      "8-byte stores), 2 groups in flight, grid of SMs x "
                      "resident blocks, grid-stride",
    "narrow_decode": "2-D grid (row, chunk of 4096), each plane's span "
                     "staged in shared memory by aligned 16-byte loads, 16 "
                     "elements a thread (funnel shift, int4 stores), rows "
                     "read in place at two strides",
    "pack_bits": "3-D grid (chunk of 2048 output bytes, stack slice, "
                 "worker), rows of any length at two strides; the chunk's "
                 "16 KB input as aligned 16-byte loads in flight, folded "
                 "to a bit stream in shared memory, 16 output bytes a "
                 "thread as one aligned store (funnel shift by the input's "
                 "misalignment), ragged ends a byte at a time",
    "unpack_bits": "one body with natural_decode: 3-D grid (chunk of "
                   "16384 elements, stack slice, worker), the sign span "
                   "staged in shared memory by aligned 16-byte loads, 4 "
                   "groups of 16 elements a thread, one aligned 16-byte "
                   "store each",
    "natural_decode": "unpack_bits' body with a Natural epilogue: code and "
                      "sign spans staged by aligned 16-byte loads, each at "
                      "its own two strides, 2 groups of 8 bf16 a thread "
                      "(byte_perm, one aligned 16-byte store each)"}
# the rows' times with each kernel's earlier design (one H100 SXM at
# 700 W, the same graph timing), printed beside this run's and not
# measured by it
EARLIER_MS = {"natural_encode": 0.1077, "narrow_decode": 0.1135,
              "narrow_encode": 0.0886, "pack_bits": 0.0238,
              "unpack_bits": 0.0232}
# f32 bit patterns of NaNs (quiet and signalling, both signs)
NAN_BITS = (0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FFFFFFF,
            0xFFFFFFFF, 0x7FA00000, 0xFFA00000)

STEPS, NS_STEPS, LAUNCHES_PER_ITERATION = 4, 5, 3
SLICE_ARGS = ["--arch", "nanogpt-124m", "--steps", str(STEPS),
              "--seq", "1024", "--batch", "8", "--workers", "2",
              "--w2s", "top10", "--s2w", "identity", "--beta", "0.5",
              "--log-every", "1", "--device", "cuda"]
SMALL_ARGS = ["--arch", "nanogpt-124m", "--reduced", "--steps", "3",
              "--seq", "64", "--batch", "4", "--workers", "2",
              "--w2s", "top10", "--log-every", "1"]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(calls, passes: int = 10, reps: int = 10) -> float:
    """Device time of one pass over ``calls``: ``passes`` passes captured
    in one CUDA graph and replayed, so the host's cost per call (Python
    wrapper, launch) does not hide the work of short kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:           # warm-up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(passes):
            for fn in calls:
                fn()
    ms = time_ms(graph.replay, reps=reps, warmup=1) / passes
    del graph
    return ms


def bound_ms(flops: float, nbytes: float,
             rate: float = F32_FLOPS) -> tuple[float, str]:
    t_op, t_b = flops / rate * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def check(name: str, got, want, tol: float) -> float:
    import torch
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rel = err / scale
    emit({"check": name, "max_abs_err": err, "rel_err": rel, "tol": tol})
    if not rel <= tol:
        fail(f"{name}: rel err {rel:.3g} > {tol:g}")
    return err


def wire_shapes(plan):
    """Row shapes the packed wire gives the wire kernels on nanogpt-124m
    with 2 workers: per narrow leaf (rows, k, width, index domain), per
    Natural leaf (rows, k). One launch covers a leaf's rows."""
    import torch
    from repro_torch.wire.codecs import NarrowIntCodec
    layout = plan.wire_layout(torch.bfloat16)
    narrow, natural = [], []
    for lp, spec in zip(plan.leaves, layout.specs):
        rows = 2 * spec.n_stack
        for name, c in zip(spec.names, spec.codecs):
            if isinstance(c, NarrowIntCodec):
                narrow.append((rows, c.shape[0], c.width,
                               math.prod(lp.slice_shape)))
            if name in ("values_codes", "codes"):
                natural.append((rows, c.shape[0]))
    return narrow, natural


def check_equal(name: str, got, want) -> float:
    """Bit-exact check of an integer/byte kernel against its plain
    version; returns the max abs difference (0)."""
    import torch
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype \
            or not torch.equal(got, want):
        diff = ((got.long() - want.long()).abs().max().item()
                if got.shape == want.shape else None)
        fail(f"{name}: not bit-equal to its plain version (max diff {diff})")
    emit({"check": name, "bit_equal": True})
    return 0.0


def stage_payloads(plan, dev, gen):
    """The staged wire layout of nanogpt-124m (2 workers) under ``plan``'s
    compressor, and random payloads for it on the card, as phase 3 makes
    them (indices in their domain)."""
    import torch
    from repro_torch.wire.codecs import NarrowIntCodec, unflatten_payload
    sw = plan.staged_wire_layout(torch.bfloat16, plan.stage_plan())
    payloads = []
    for lp, spec in zip(plan.leaves, sw.base.specs):
        leaves = []
        for c in spec.codecs:
            shape = (2,) + spec.stack_shape + c.shape
            dtype = torch.int32 if isinstance(c, NarrowIntCodec) else c.dtype
            if dtype.is_floating_point:
                leaves.append(torch.randn(shape, device=dev, generator=gen)
                              .to(dtype))
                continue
            hi = (math.prod(lp.slice_shape) if isinstance(c, NarrowIntCodec)
                  else 256 if dtype == torch.uint8 else 2**31 - 1)
            leaves.append(torch.randint(0, hi, shape, device=dev,
                                        generator=gen).to(dtype))
        payloads.append(unflatten_payload(spec.names, leaves))
    return sw, payloads


def stage_columns(sw, payloads, bufs):
    """Each narrow leaf's column of its region of the stage buffers,
    ``[2, n_stack, nbytes]`` (the view ``NarrowIntCodec`` hands the narrow
    kernels), with its width and its indices ``[2, n_stack, k]``."""
    from repro_torch.wire.codecs import NarrowIntCodec
    out = []
    for k, stage in enumerate(sw.stages):
        for i, spec in zip(sw.stage_leaf_ids[k], stage.specs):
            region = spec.region(bufs[k])
            for name, c, o in zip(spec.names, spec.codecs, spec.splits):
                if isinstance(c, NarrowIntCodec):
                    idx = payloads[i][name].reshape(2, spec.n_stack, -1)
                    out.append((region[:, :, o:o + c.nbytes], c.width,
                                idx.contiguous()))
    return out


def to_cpu(payload):
    from repro_torch.wire.codecs import flatten_payload, unflatten_payload
    names, leaves = flatten_payload(payload)
    return unflatten_payload(names, [x.cpu() for x in leaves])


def old_pack_copies(sw, payloads):
    """The copies the pack path made until the codecs wrote the stage
    buffers in place, as calls on this run's payloads: per stage, the
    ``torch.cat`` of each leaf's codec outputs and the ``torch.cat`` of
    the leaves (the codec outputs themselves are made here, untimed)."""
    import torch
    from repro_torch.wire.codecs import flatten_payload
    calls = []
    for k, stage in enumerate(sw.stages):
        leaf_parts = []
        for i, spec in zip(sw.stage_leaf_ids[k], stage.specs):
            leaves = flatten_payload(payloads[i])[1]
            leaf_parts.append([
                c.pack(x.reshape((2 * spec.n_stack,) + c.shape))
                for c, x in zip(spec.codecs, leaves)])

        def cat(leaf_parts=leaf_parts):
            return torch.cat([(p[0] if len(p) == 1 else torch.cat(p, 1))
                              .reshape(2, -1) for p in leaf_parts], 1)
        calls.append(cat)
    return calls


def old_unpack_copies(sw, bufs):
    """The copies the unpack path made until it read the stage buffers in
    place: the reshape of each leaf's region of a multi-leaf stage into
    ``[n_workers * n_stack, slice_nbytes]`` rows (a copy), and
    ``RawCodec``'s ``contiguous()`` of its uint8 columns of those rows."""
    import torch
    from repro_torch.wire.codecs import RawCodec
    calls = []
    for k, stage in enumerate(sw.stages):
        for spec in stage.specs:
            seg = bufs[k][:, spec.offset:spec.offset + spec.region_nbytes]
            shape = (2 * spec.n_stack, spec.slice_nbytes)
            if not seg.is_contiguous():
                calls.append(lambda seg=seg, shape=shape: seg.reshape(shape))
            rows = seg.reshape(shape)     # the rows the codecs got, untimed
            for c, o in zip(spec.codecs, spec.splits):
                if isinstance(c, RawCodec) and c.dtype == torch.uint8:
                    calls.append(lambda rows=rows, o=o, n=c.nbytes:
                                 rows[:, o:o + n].contiguous())
    return calls


def wire_kernel_rows(dev, gen, plan, plan_top10,
                     natural_arm) -> list[dict]:
    """Phase 3b: the wire kernels against their plain versions, bit for
    bit, at the main path's row shapes, ragged ones, misaligned and
    strided ones, in place in the packed top10 and top10+natural stage
    buffers, and at the natural arm's rows ``natural_arm``; times of
    kernel and plain version over one step's calls (CUDA events)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import bitpack as bp
    from repro_torch.kernels import natural_pack as nat
    from repro_torch.kernels import ref
    narrow, natural = wire_shapes(plan)
    emit({"wire_shapes": {"narrow": narrow, "natural": natural}})

    def randint(hi, *shape):
        return torch.randint(0, hi, shape, device=dev, generator=gen,
                             dtype=torch.int64).to(torch.int32)

    def values(rows, k, dtype):
        x = torch.randn((rows, k), device=dev, generator=gen)
        x = x * torch.exp2(torch.randint(-140, 120, (rows, k), device=dev,
                                         generator=gen).float())
        # +-0, subnormals, ties of the power-of-two rounding, the overflow
        # edge, +-inf, then NaNs of both signs
        special = torch.cat([torch.tensor(
            [0.0, -0.0, 1e-45, -1e-40, 1.5, -1.5, 0.75, -0.7499, 3.39e38,
             float("inf"), -float("inf")]), torch.from_numpy(
                 np.array(NAN_BITS, np.uint32).view(np.float32))]).to(dev)
        m = min(x.numel(), special.numel())
        x.view(-1)[:m] = special[:m]
        return x.to(dtype)

    # main path: u24 indices in their domain (the last one at its top),
    # bf16 TopK values, {0,1} sign planes of the values' length (no row is
    # whole bytes), codes of every byte value
    idx_main = []
    for rows, k, width, dom in narrow:
        x = randint(dom, rows, k)
        x[-1, -1] = dom - 1
        idx_main.append((x, width))
    enc_main = [(bp.narrow_encode_ref(x, w), w) for x, w in idx_main]
    val_main = [values(rows, k, torch.bfloat16) for rows, k in natural]
    bits_main = [randint(2, rows, k).to(torch.uint8) for rows, k in natural]
    pack_main = [bp.pack_bits_ref(b) for b in bits_main]
    codes_main = [randint(256, rows, k).to(torch.uint8)
                  for rows, k in natural]

    # ragged: k % 8 != 0, k % 128 != 0, k = 1, values at 2^(8w) - 1
    idx_extra = []
    for rows, k in ((1, 1), (3, 7), (2, 129), (5, 1003)):
        for width in (2, 3, 4):
            x = randint(min(1 << (8 * width), 2**31 - 1), rows, k)
            x[0, 0] = min(1 << (8 * width), 2**31) - 1
            idx_extra.append((x, width))
    val_extra = [values(r, k, dt) for r, k in ((1, 1), (3, 7), (2, 129))
                 for dt in (torch.float32, torch.bfloat16)]
    # sign rows of any length: k % 8 = 0..7, one row longer than a grid
    # row of blocks needs at once; and more rows than the grid's 65,535 in
    # y (the kernels loop over rows)
    bits_extra = [randint(2, r, k).to(torch.uint8)
                  for r, k in [(1, 1), (3, 7), (2, 129), (1, 9_000_001),
                               (65_537, 5), (70_000, 67)]
                  + [(3, 8 * 1003 + m) for m in range(8)]]
    idx_extra += [(randint(1 << 24, 65_537, 5), 3),
                  (randint(1 << 16, 70_000, 67), 2)]
    for x, w in idx_main + idx_extra:
        tag = f"[{x.shape[0]},{x.shape[1]}]u{8 * w}"
        e = bp.narrow_encode(x, w)
        check_equal(f"narrow_encode{tag}", e, bp.narrow_encode_ref(x, w))
        check_equal(f"narrow_decode{tag}", bp.narrow_decode(e, w),
                    bp.narrow_decode_ref(e, w))
        check_equal(f"narrow round trip{tag}", bp.narrow_decode(e, w), x)

    def natural_decode_equal(tag, codes, packed):
        check_equal(f"natural_decode{tag}",
                    bp.natural_decode(codes, packed).view(torch.int16),
                    bp.natural_decode_ref(codes, packed).view(torch.int16))

    def bit_rows_equal(tag, b, codes):
        """pack_bits of the {0,1} rows ``b``, then unpack_bits and
        natural_decode (with ``codes``) of the packed rows."""
        p = bp.pack_bits(b)
        check_equal(f"pack_bits{tag}", p, bp.pack_bits_ref(b))
        check_equal(f"unpack_bits{tag}", bp.unpack_bits(p),
                    bp.unpack_bits_ref(p))
        check_equal(f"bits round trip{tag}",
                    bp.unpack_bits(p)[..., :b.shape[-1]], b)
        natural_decode_equal(tag, codes, p)

    for b in bits_main + bits_extra:
        bit_rows_equal(f"[{b.shape[0]},{b.shape[1]}]", b,
                       randint(256, *b.shape).to(torch.uint8))
    # the natural arm: Natural on whole slices (one row a worker's slice)
    for rows, k in natural_arm:
        bit_rows_equal(f"[{rows},{k}] natural arm",
                       randint(2, rows, k).to(torch.uint8),
                       randint(256, rows, k).to(torch.uint8))
        torch.cuda.empty_cache()
    for v in val_main + val_extra:
        tag = f"[{v.shape[0]},{v.shape[1]}]{str(v.dtype)[6:]}"
        c, sg = nat.natural_encode(v)
        rc, rs = ref.natural_compress_ref(v)
        check_equal(f"natural_encode codes{tag}", c, rc)
        check_equal(f"natural_encode signs{tag}", sg, rs)

    # misaligned and strided: inputs and outputs 1-15 elements into a
    # larger buffer (bf16 at odd element offsets too); encodes into and
    # decodes of column slices and of the columns of leaf regions at odd
    # byte offsets and row strides; the packed top10 stage buffers
    k_main = narrow[0][1]
    nb_main = -(-k_main // 8)
    for off in range(1, 16):
        b = randint(2, 3 * k_main + 16).to(torch.uint8)[off:off + 3 * k_main]
        check_equal(f"pack_bits[3,{k_main}] at byte {off}",
                    bp.pack_bits(b.view(3, k_main)),
                    bp.pack_bits_ref(b.view(3, k_main)))
        signs = randint(256, 3 * nb_main + 16).to(torch.uint8)[
            off:off + 3 * nb_main].view(3, nb_main)
        check_equal(f"unpack_bits[3,{nb_main}] at byte {off}",
                    bp.unpack_bits(signs), bp.unpack_bits_ref(signs))
        codes = randint(256, 3 * k_main + 16).to(torch.uint8)[
            16 - off:16 - off + 3 * k_main].view(3, k_main)
        natural_decode_equal(f"[3,{k_main}] codes at byte {16 - off}, signs "
                             f"at byte {off}", codes, signs)
        flat = randint(256, 3 * 3 * k_main + 16).to(torch.uint8)
        e = flat[off:off + 3 * 3 * k_main].view(3, 3 * k_main)
        check_equal(f"narrow_decode[3,{3 * k_main}]u24 at byte {off}",
                    bp.narrow_decode(e, 3), bp.narrow_decode_ref(e, 3))
        x = randint(1 << 24, 3 * k_main + 16)[off:off + 3 * k_main]
        before = flat.clone()
        bp.narrow_encode(x.view(3, k_main), 3, out=e)
        rest = torch.ones_like(flat, dtype=torch.bool)
        rest[off:off + e.numel()] = False
        check_equal(f"narrow_encode[3,{k_main}]u24 from element {off} to "
                    f"byte {off}", torch.cat([e.reshape(-1), flat[rest]]),
                    torch.cat([bp.narrow_encode_ref(x.view(3, k_main), 3)
                               .reshape(-1), before[rest]]))
        for dt in (torch.float32, torch.bfloat16):
            v = values(1, 3 * k_main + 16, dt)[0, off:off + 3 * k_main]
            c, sg = nat.natural_encode(v)
            rc, rs = ref.natural_compress_ref(v)
            check_equal(f"natural_encode[{v.numel()}]{str(dt)[6:]} at "
                        f"element {off}", torch.stack([c, sg]),
                        torch.stack([rc, rs]))
    for rows, k in ((24, k_main), (5, 1003)):
        for off, pad in ((1, 0), (3, 7), (5, 13), (13, 2)):
            buf = randint(256, rows, off + 3 * k + pad).to(torch.uint8)
            e = buf[:, off:off + 3 * k]
            check_equal(f"narrow_decode[{rows},{3 * k}]u24 column slice at "
                        f"byte {off}, stride {buf.shape[1]}",
                        bp.narrow_decode(e, 3), bp.narrow_decode_ref(e, 3))
    def column(buf, n_stack, off, n, pad):
        """The column [off, off + n) of the leaf region [2, n_stack, off +
        n + pad] at byte ``pad`` of the [2, T] tensor ``buf``."""
        s_slice = off + n + pad
        return buf[:, pad:pad + n_stack * s_slice].unflatten(
            1, (n_stack, s_slice))[:, :, off:off + n]

    def region_column(n_stack, off, n, pad, hi):
        """A [2, T] buffer of random bytes below ``hi`` (T odd) and its
        ``column``."""
        buf = randint(hi, 2, n_stack * (off + n + pad) + 2 * pad + 1).to(
            torch.uint8)
        return buf, column(buf, n_stack, off, n, pad)

    # the column [off, off + n) of a leaf region [2, n_stack, s_slice] of a
    # [2, T] buffer, T and s_slice odd: written by the encode with every
    # other byte kept, read by the decode and the bit unpack
    for n_stack, k in ((12, k_main), (3, 1003), (1, 17)):
        for off, pad in ((1, 0), (3, 7), (5, 13), (13, 2)):
            for w in (2, 3, 4):
                buf, col = region_column(n_stack, off, w * k, pad, 256)
                x = randint(min(1 << (8 * w), 2**31 - 1), 2, n_stack, k)
                before = buf.clone()
                bp.narrow_encode(x, w, out=col)
                keep = torch.ones_like(buf, dtype=torch.bool)
                column(keep, n_stack, off, w * k, pad)[...] = False
                tag = (f"[2,{n_stack},{w * k}]u{8 * w} region column at byte "
                       f"{off}, strides ({buf.stride(0)}, {col.stride(1)})")
                check_equal(f"narrow_encode{tag}",
                            torch.cat([col.reshape(-1), buf[keep]]),
                            torch.cat([bp.narrow_encode_ref(x, w).reshape(-1),
                                       before[keep]]))
                check_equal(f"narrow_decode{tag}", bp.narrow_decode(col, w),
                            x)
            packed = col[..., :k]
            check_equal(f"unpack_bits[2,{n_stack},{k}] region column at "
                        f"byte {off}", bp.unpack_bits(packed),
                        bp.unpack_bits_ref(packed))
            # pack_bits of a {0,1} column, natural_decode of a code column
            # and a sign column of two other regions; every buffer kept
            nb = -(-k // 8)
            bbuf, bits = region_column(n_stack, off, k, pad, 2)
            cbuf, codes = region_column(n_stack, (off + 3) % 16, k, pad + 1,
                                        256)
            sbuf, signs = region_column(n_stack, (off + 7) % 16, nb, pad + 2,
                                        256)
            before = [x.clone() for x in (bbuf, cbuf, sbuf)]
            tag = f"[2,{n_stack},{k}] region columns at byte {off}"
            check_equal(f"pack_bits{tag}", bp.pack_bits(bits),
                        bp.pack_bits_ref(bits))
            natural_decode_equal(tag, codes, signs)
            for x, was in zip((bbuf, cbuf, sbuf), before):
                check_equal(f"buffer kept around {tag}", x, was)

    # the packed top10 stage buffers: packed on the card (each codec
    # writing its column of each leaf region in place), against the plain
    # path's on the CPU; then each narrow column decoded in place
    sw, payloads = stage_payloads(plan_top10, dev, gen)
    bufs = [sw.pack_stage(k, payloads) for k in range(sw.n_stages)]
    cpu_payloads = [to_cpu(p) for p in payloads]
    for k, buf in enumerate(bufs):
        check_equal(f"top10 stage {k} {list(buf.shape)} packed in place on "
                    "the card vs the plain path on the CPU", buf.cpu(),
                    sw.pack_stage(k, cpu_payloads))
    del cpu_payloads
    in_step = stage_columns(sw, payloads, bufs)
    for e, w, idx in in_step:
        check_equal(f"narrow_decode in place, top10 stage column "
                    f"{list(e.shape)} strides {e.stride()[:2]} at byte "
                    f"{e.storage_offset()}", bp.narrow_decode(e, w), idx)
    pack_copies = old_pack_copies(sw, payloads)
    unpack_copies = {"top10": old_unpack_copies(sw, bufs)}
    sw_nat, pl_nat = stage_payloads(plan, dev, gen)
    bufs_nat = [sw_nat.pack_stage(k, pl_nat) for k in range(sw_nat.n_stages)]
    unpack_copies["top10+natural"] = old_unpack_copies(sw_nat, bufs_nat)
    del pl_nat
    # each Natural leaf's codes and signs as the codec hands them over
    # (views of the top10+natural stage buffers), decoded in place
    nat_in_step = []
    for k, buf in enumerate(bufs_nat):
        for pl in sw_nat.unpack_stage(k, buf):
            if isinstance(pl, dict) and "values_codes" in pl:
                c, sg = pl["values_codes"], pl["values_signs"]
                tag = (f" in place, top10+natural stage columns "
                       f"{list(c.shape)} at byte {c.storage_offset()}, signs "
                       f"at byte {sg.storage_offset()}, row stride "
                       f"{c.stride(0)}")
                natural_decode_equal(tag, c, sg)
                check_equal(f"unpack_bits{tag}", bp.unpack_bits(sg),
                            bp.unpack_bits_ref(sg))
                nat_in_step.append((c, sg))
    if len(nat_in_step) != len(natural):
        fail(f"{len(nat_in_step)} Natural leaves in the top10+natural stage "
             f"buffers, the layout has {len(natural)}")

    def row(name, kernel, plain, args, nbytes, ops):
        """Times of one step's calls (one per leaf): device time from a
        CUDA graph for kernel and plain version alike; beside it the
        eager calls as the step makes them (host cost included)."""
        b, by = bound_ms(ops, nbytes, rate=INT32_OPS_S)
        calls = [lambda a=a: kernel(*a) for a in args]
        plain_calls = [lambda a=a: plain(*a) for a in args]
        r = {"name": name, "route": "cuda",
             "source": ("src/repro_torch/kernels/csrc/natural_pack.cu"
                        if name == "natural_encode" else
                        "src/repro_torch/kernels/csrc/bitpack.cu"),
             "replaces": REPLACES[name], "max_abs_err": 0.0,
             "ms": graph_ms(calls), "plain_ms": graph_ms(plain_calls),
             "bound_ms": b, "bound_by": by, "library_ms": None}
        times = {"wire_kernel_times": name, "graph_ms": r["ms"],
                 "plain_graph_ms": r["plain_ms"],
                 "eager_calls_ms": sum(time_ms(fn) for fn in calls),
                 "plain_eager_calls_ms": sum(time_ms(fn)
                                             for fn in plain_calls),
                 "calls": len(calls), "bound_ms": b}
        if name in WIRE_DESIGN:
            r["design"] = WIRE_DESIGN[name]
            r["fraction_of_bound"] = b / r["ms"]
            r["tb_s"] = nbytes / r["ms"] / 1e9
            times["earlier_ms"] = EARLIER_MS.get(name)
            # each leaf's call alone, beside its own bytes: what a launch
            # costs beyond its bytes shows on the small leaves
            n_in = sum(a[0].numel() for a in args)
            times["per_call_ms"] = [graph_ms([fn]) for fn in calls]
            times["per_call_bytes"] = [nbytes * a[0].numel() // n_in
                                       for a in args]
        if name == "narrow_decode":
            # the decodes as the codec makes them (columns of the stage
            # buffers' leaf regions, in place), and the copies the codec
            # made of those columns before its decode until it read them in
            # place
            r["in_step_ms"] = graph_ms([lambda e=e, w=w: kernel(e, w)
                                        for e, w, _ in in_step])
            r["copy_ms"] = graph_ms([lambda e=e: e.contiguous()
                                     for e, _, _ in in_step])
        if name == "narrow_encode":
            # the encodes as the codec makes them (into the columns of the
            # stage buffers' leaf regions), and the two concatenations that
            # assembled the stage buffers until the codecs wrote them
            r["in_step_ms"] = graph_ms([lambda e=e, w=w, x=x: kernel(
                x, w, out=e) for e, w, x in in_step])
            r["copy_ms"] = graph_ms(pack_copies)
        if name in ("pack_bits", "unpack_bits", "natural_decode"):
            # every call's output kept alive, so no two calls write one
            # buffer: the graph's pool otherwise hands each call the
            # buffer the last one freed, which may stay in the 50 MB L2
            kept = []
            r["kept_outputs_ms"] = graph_ms([lambda a=a: kept.append(
                kernel(*a)) for a in args])
            del kept
        if name == "pack_bits":
            # the zero pads that made every sign row whole bytes before
            # its pack until pack_bits packed ragged rows
            r["pad_ms"] = graph_ms([lambda b=b: F.pad(
                b, (0, (-b.shape[-1]) % 8)) for (b,) in args])
        if name == "natural_decode":
            # the decodes as the codec hands them over (the columns of the
            # top10+natural stage buffers, in place), and the chain they
            # replace as the step ran it: unpack_bits of the sign columns,
            # the slice to k and the plain decode's elementwise PyTorch
            # operations (device time of the eager operations in a graph,
            # and the eager calls)
            r["in_step_ms"] = graph_ms([lambda c=c, sg=sg: kernel(c, sg)
                                        for c, sg in nat_in_step])
            chain = [lambda c=c, sg=sg: ref.natural_decompress_ref(
                c, bp.unpack_bits(sg)[..., :c.shape[-1]])
                for c, sg in nat_in_step]
            r["chain_ms"] = graph_ms(chain)
            r["chain_eager_ms"] = sum(time_ms(fn) for fn in chain)
            times["in_step_eager_ms"] = sum(
                time_ms(lambda c=c, sg=sg: kernel(c, sg))
                for c, sg in nat_in_step)
        emit({**times, **{k: r[k] for k in ("design", "fraction_of_bound",
                                           "tb_s", "in_step_ms", "copy_ms",
                                           "pad_ms", "chain_ms",
                                           "chain_eager_ms",
                                           "kept_outputs_ms")
                          if k in r}})
        torch.cuda.empty_cache()
        return r

    # bytes: each input read once, each output written once; integer
    # operations per element, address arithmetic aside
    n_idx = sum(x.numel() for x, _ in idx_main)
    n_val = sum(v.numel() for v in val_main)
    n_bits = sum(b.numel() for b in bits_main)
    n_bytes_packed = sum(p.numel() for p in pack_main)
    w_idx = sum(x.numel() * w for x, w in idx_main)
    rows = [
        row("narrow_encode", bp.narrow_encode, bp.narrow_encode_ref,
            idx_main, 4 * n_idx + w_idx, 2 * w_idx),
        row("narrow_decode", bp.narrow_decode, bp.narrow_decode_ref,
            enc_main, w_idx + 4 * n_idx, 2 * w_idx),
        row("pack_bits", bp.pack_bits, bp.pack_bits_ref,
            [(b,) for b in bits_main], n_bits + n_bytes_packed, 4 * n_bits),
        row("unpack_bits", bp.unpack_bits, bp.unpack_bits_ref,
            [(p,) for p in pack_main], 9 * n_bytes_packed,
            2 * 8 * n_bytes_packed),
        # codes and packed signs in, bf16 out; ~3 operations an element
        row("natural_decode", bp.natural_decode, bp.natural_decode_ref,
            list(zip(codes_main, pack_main)),
            3 * n_bits + n_bytes_packed, 3 * n_bits),
        row("natural_encode", nat.natural_encode, ref.natural_compress_ref,
            [(v,) for v in val_main], 4 * n_val, 10 * n_val),
    ]
    # the copies the unpack path no longer makes, per packed path's step
    emit({"unpack_copies_removed_ms": {w2s: graph_ms(calls) if calls else 0.0
                                       for w2s, calls in
                                       unpack_copies.items()},
          "calls": {w2s: len(c) for w2s, c in unpack_copies.items()}})
    del bufs, bufs_nat, payloads, pack_copies, unpack_copies, in_step, \
        nat_in_step
    torch.cuda.empty_cache()
    return rows + [cast_row(dev, gen, plan_top10)]


def cast_row(dev, gen, plan) -> dict:
    """The f32 -> bf16 cast with XLA's NaN bits over one step's EF21
    differences (2 workers, every lossy leaf of ``plan``): the kernel bit
    for bit against its plain version (PyTorch's cast and a torch.where on
    isnan), NaNs of both signs, +-inf, +-0 and subnormals among the
    values, and an input not 16-byte aligned; kernel, plain version and
    PyTorch's own cast timed as CUDA-graph replays of the step's calls."""
    import numpy as np
    import torch
    from repro_torch.kernels import natural_pack as nat
    from repro_torch.kernels import ref
    special = torch.from_numpy(np.array(
        NAN_BITS + (0x7F800000, 0xFF800000, 0, 0x80000000, 1, 0x80000001,
                    0x00018000, 0x3F808000, 0x3F818000, 0x7F7FFFFF),
        np.uint32).view(np.float32)).to(dev)
    diffs = []
    for lp in plan.leaves:
        if not getattr(lp.w2s, "lossless_wire", False):
            d = torch.randn((2,) + lp.shape, device=dev, generator=gen)
            d.view(-1)[:special.numel()] = special
            diffs.append(d)
    for d in diffs + [diffs[0].view(-1)[1:1004]]:
        check_equal(f"to_bf16{list(d.shape)} at element "
                    f"{d.storage_offset()}", nat.to_bf16(d).view(torch.int16),
                    ref.to_bf16_ref(d).view(torch.int16))
    n = sum(d.numel() for d in diffs)
    # 6 bytes an element; ~8 integer operations (the NaN test, the
    # rounding, the select)
    b, by = bound_ms(8 * n, 6 * n, rate=INT32_OPS_S)
    r = {"name": "to_bf16", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/natural_pack.cu",
         "replaces": REPLACES["to_bf16"], "max_abs_err": 0.0,
         "ms": graph_ms([lambda d=d: nat.to_bf16(d) for d in diffs],
                        passes=4),
         "plain_ms": graph_ms([lambda d=d: ref.to_bf16_ref(d)
                               for d in diffs], passes=4),
         "bound_ms": b, "bound_by": by, "library_ms": None}
    r["fraction_of_bound"] = b / r["ms"]
    r["tb_s"] = 6 * n / r["ms"] / 1e9
    torch_ms = graph_ms([lambda d=d: d.to(torch.bfloat16) for d in diffs],
                        passes=4)
    emit({"to_bf16_times": "one step's EF21 casts", "elements": n,
          "calls": len(diffs), "kernel_ms": r["ms"],
          "plain_rule_ms": r["plain_ms"], "torch_cast_ms": torch_ms,
          "kernel_over_torch_cast_ms": r["ms"] - torch_ms,
          "plain_rule_over_torch_cast_ms": r["plain_ms"] - torch_ms,
          "bound_ms": b, "fraction_of_bound": r["fraction_of_bound"]})
    return r


REPLACES = {"narrow_encode": "src/repro/kernels/bitpack.py:188",
            "narrow_decode": "src/repro/kernels/bitpack.py:214",
            "pack_bits": "src/repro/kernels/bitpack.py:118",
            "unpack_bits": "src/repro/kernels/bitpack.py:140",
            "natural_encode": "src/repro/kernels/natural_pack.py:28",
            # unpack_bits' body; its epilogue is the reference's jnp
            # decode behind unpack_bits (src/repro/kernels/ops.py:215)
            "natural_decode": "src/repro/kernels/bitpack.py:140",
            # not a TPU kernel: XLA's convert, diff.astype(wire_dtype)
            "to_bf16": "src/repro/core/error_feedback.py:38"}


def reset_all_launches() -> None:
    from repro_torch.kernels import bitpack, natural_pack, newton_schulz
    for mod in (bitpack, natural_pack, newton_schulz):
        mod.reset_launches()


def all_launches() -> dict:
    from repro_torch.kernels import bitpack, natural_pack, newton_schulz
    return {**newton_schulz.LAUNCHES, **bitpack.LAUNCHES,
            **natural_pack.LAUNCHES}


def wire_round_trip(args, group) -> None:
    """Step 0's full-width payloads (2 workers, from the initial state
    on the first batch, as phase 3 makes them) through each stage's
    pack -> all-gather -> unpack: every payload leaf comes back bit for
    bit."""
    import torch
    from repro_torch.core.error_feedback import ef_compress_step
    from repro_torch.launch import train as train_cli
    from repro_torch.wire.codecs import flatten_payload
    _, tr, data, _ = train_cli.setup(args, group=group)
    state = tr.init(args.seed)
    plan, cfg = tr.layer_plan(), tr.opt.cfg
    batch = data.batch_at(0)
    grads = [plan.flatten(tr._grad_and_loss(
        state["x"], {k: v[j] for k, v in batch.items()})[1])
        for j in range(cfg.n_workers)]
    payloads = []
    for i, lp in enumerate(plan.leaves):
        g = torch.stack([gw[i] for gw in grads]).to(torch.float32)
        payloads.append(ef_compress_step(
            lp.w2s, {}, torch.zeros_like(g), cfg.beta * g, lp.slice_shape,
            cfg.wire_dtype)[0])
    del grads
    sw = plan.staged_wire_layout(cfg.wire_dtype, plan.stage_plan())
    n_leaves = 0
    for k in range(sw.n_stages):
        got = sw.unpack_stage(k, tr._gather(sw.pack_stage(k, payloads)))
        for i, pl in zip(sw.stage_leaf_ids[k], got):
            names, leaves = flatten_payload(pl)
            _, want = flatten_payload(payloads[i])
            for name, a, b in zip(names, leaves, want):
                if a.dtype != b.dtype or not torch.equal(a, b):
                    fail(f"wire round trip: leaf {i} payload {name} "
                         "changed through pack -> gather -> unpack")
            n_leaves += 1
    torch.cuda.synchronize()
    emit({"check": f"step-0 payloads through the {args.w2s} wire",
          "stages": sw.n_stages, "leaves": n_leaves,
          "bytes_gathered": sum(tr.gathered), "bit_equal": True})


def packed_run(args, group, n_ns_iters: int) -> dict:
    """4 full-width steps through a Trainer over ``group``: checks the
    losses, the gathers against the wire budget and every kernel's
    launches against what the layout implies."""
    import torch
    from repro_torch.launch import train as train_cli
    cfg, tr, data, sched = train_cli.setup(args, group=group)
    budget = tr.wire_budget()
    narrow, natural = wire_shapes(tr.layer_plan())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    out = train_cli.run_steps(tr, tr.init(args.seed), data, sched, STEPS)
    torch.cuda.synchronize()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    emit({"packed": args.w2s, "steps": STEPS, "losses": losses,
          "step_s": out["step_s"], "peak_mem_bytes": peak,
          "gathers_per_step": len(tr.gathered) / STEPS,
          "gathered_bytes_per_step": sum(tr.gathered) / STEPS,
          "w2s_sizes": budget.w2s_sizes, "launches": launches})
    if len(losses) != STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"{args.w2s} packed run: non-finite or missing losses {losses}")
    if budget.w2s_nbytes != WIRE_BYTES[args.w2s] or budget.n_stages != 3:
        fail(f"{args.w2s} wire budget {budget}")
    if tr.gathered != [2 * s for s in budget.w2s_sizes] * STEPS:
        fail(f"{args.w2s} gathers {tr.gathered}, expected "
             f"{[2 * s for s in budget.w2s_sizes]} per step")
    # one cast of the EF21 difference per lossy leaf; one launch per leaf
    # and direction: encode in pack, decode in unpack;
    # Natural encodes and packs signs once per leaf in compress, and
    # decodes codes and packed signs in one natural_decode launch in both
    # decompresses (the sender's EF21 estimate and the server's fold):
    # unpack_bits' body runs there, the bits epilogue never
    n_lossy = sum(not getattr(lp.w2s, "lossless_wire", False)
                  for lp in tr.layer_plan().leaves)
    want = {"ns_iteration": 2 * n_ns_iters, "fused_matmul": n_ns_iters,
            "to_bf16": STEPS * n_lossy,
            "narrow_encode": STEPS * len(narrow),
            "narrow_decode": STEPS * len(narrow),
            "natural_encode": STEPS * len(natural),
            "pack_bits": STEPS * len(natural),
            "natural_decode": 2 * STEPS * len(natural),
            "unpack_bits": 0}
    if launches != want:
        fail(f"{args.w2s} launches {launches}, the layout implies {want}")
    return {"losses": losses, "step_s": out["step_s"], "peak": peak,
            "launches": launches}


def ns_kernel_rows(dev, gen) -> list[dict]:
    """Phase 3a: the NS kernels against their plain versions (and the
    symmetric kernel's exact symmetry), then the rows of both kernels:
    times of kernel, plain version and cuBLAS over one NS iteration of
    both buckets (CUDA events), bounds and rates. Everything it
    allocates dies with it."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.newton_schulz import (TILE, fused_matmul,
                                                   ns_iteration,
                                                   syrk_upper)
    randn = lambda *s: torch.randn(s, device=dev, generator=gen)
    a_, b_, c_ = ref.NS_COEFFS

    def normalise(x):
        return x / x.flatten(1).norm(dim=1)[:, None, None]

    def normalised(*s):
        return normalise(randn(*s))

    def wide(*s):
        """Entries spanning ~2^20 in magnitude: a random power of two in
        [2^-10, 2^10] per entry (a lost lo part of the 3xTF32 split shows
        at ~2^-11 of the largest terms)."""
        e = torch.randint(-10, 11, s, device=dev, generator=gen).float()
        return randn(*s) * torch.exp2(e)

    buckets = [normalised(48, 768, 768), normalised(24, 768, 3072)]
    wide_buckets = [normalise(wide(48, 768, 768)),
                    normalise(wide(24, 768, 3072))]

    def ns_checks(x, tag, chain=True):
        err = check(f"ns_iteration{list(x.shape)}{tag}", ns_iteration(x),
                    ref.ns_iteration_batched_ref(x), TOL_ONE_PASS)
        if chain:
            err = max(err, check(
                f"newton_schulz_batched{list(x.shape)}x{NS_STEPS}{tag}",
                ops.newton_schulz_batched(x, steps=NS_STEPS),
                ref.newton_schulz_batched_ref(x, steps=NS_STEPS),
                TOL_NS_CHAIN))
        return err

    # the rows' max_abs_err is over the main path's checks; every other
    # check is held to its tolerance all the same
    err_ns = max(ns_checks(x, "") for x in buckets)
    for x in wide_buckets:
        ns_checks(x, " wide")
    ns_checks(normalised(3, 200, 328), "", chain=False)
    # the symmetric kernel alone: the gram and the poly of each bucket,
    # wide inputs, ragged shapes (K = 77: rows not 16-byte aligned), with
    # and without C; exactly symmetric
    syrk_cases = []
    for x in buckets + wide_buckets:
        g = ref.syrk_upper_ref(x)
        syrk_cases += [(x, None, 1.0, 1.0), (g, g, b_, c_)]
    c = wide(3, 200, 200)
    syrk_cases += [(wide(3, 200, 328), c + c.mT, -0.3, 1.7),
                   (randn(2, 130, 77), None, 1.0, -1.3),
                   (randn(2, 130, 77), randn(2, 130, 130), 0.7, -1.3),
                   (randn(130, 77), randn(130, 130), 0.7, 2.0)]
    for X, C, al, be in syrk_cases:
        got = syrk_upper(X, C, alpha=al, beta=be)
        if not torch.equal(got, got.mT):
            fail(f"syrk_upper{list(X.shape)}: result not exactly symmetric")
        check(f"syrk_upper{list(X.shape)}{'+C' if C is not None else ''}",
              got, ref.syrk_upper_ref(X, C, al, be), TOL_ONE_PASS)

    # the grams against float64, beside cuBLAS's f32 gram: the kernel's
    # 64-deep spans of K are summed apart and added in f32 (a sum truncated
    # through all of K = 3072 would miss TOL_ONE_PASS)
    for x, tag in ([(x, "") for x in buckets]
                   + [(x, " wide") for x in wide_buckets]):
        xd = x.double()
        want = xd @ xd.mT
        check(f"syrk_upper{list(x.shape)}{tag} vs float64", syrk_upper(x),
              want, TOL_ONE_PASS)
        emit({"cublas_f32_gram_vs_float64": f"{list(x.shape)}{tag}",
              "rel_err": ((torch.bmm(x, x.mT) - want).abs().max()
                          / want.abs().max()).item()})
        del xd, want

    # fused_matmul as the first NS design called it (poly: G@G + C,
    # update: P@X + C; the row's times stay comparable across designs),
    # then without C, transposed, ragged, wide
    mm_main = []
    for x in buckets:
        bsz, m, _ = x.shape
        g = torch.bmm(x, x.mT)
        mm_main.append((g, g, g, b_, c_, False))
        mm_main.append((randn(bsz, m, m) * 0.1, x, x, a_, 1.0, False))
    mm_extra = [(randn(48, 768, 768), randn(48, 768, 768), None, 1.0, 1.0,
                 False),
                (randn(24, 768, 3072), randn(24, 768, 3072), None, 1.0,
                 1.0, True),
                (randn(3, 200, 328), randn(3, 200, 328), randn(3, 200, 200),
                 0.7, -1.3, True),
                (randn(200, 77), randn(77, 259), randn(200, 259), -0.5, 2.0,
                 False),
                (randn(2, 130, 77), randn(2, 259, 77), None, 0.7, -1.3,
                 True)]
    for x in wide_buckets:
        bsz, m, n = x.shape
        g = ref.syrk_upper_ref(x)
        mm_extra += [(g, x, x, a_, 1.0, False),
                     (wide(bsz, m, n), wide(bsz, m, n), None, 1.0, 1.0,
                      True)]

    def mm_check(A, B, C, al, be, tb):
        return check(f"fused_matmul{list(A.shape)}x{list(B.shape)}"
                     f"{'^T' if tb else ''}{'+C' if C is not None else ''}",
                     fused_matmul(A, B, C, alpha=al, beta=be, trans_b=tb),
                     ref.fused_matmul_ref(A, B.mT if tb else B, C, al, be),
                     TOL_ONE_PASS)

    err_mm = max(mm_check(*case) for case in mm_main)
    for case in mm_extra:
        mm_check(*case)

    # times over one NS iteration of both buckets
    def ns_library(x):
        g = torch.bmm(x, x.mT)
        return torch.baddbmm(x, torch.baddbmm(g, g, g, beta=b_, alpha=c_),
                             x, beta=a_)

    ns_row = {"name": "ns_iteration", "route": "cuda", "design": NS_DESIGN,
              "source": "src/repro_torch/kernels/csrc/newton_schulz.cu",
              "replaces": "src/repro/kernels/newton_schulz.py:160",
              "max_abs_err": err_ns,
              "ms": sum(time_ms(lambda x=x: ns_iteration(x))
                        for x in buckets),
              "plain_ms": sum(time_ms(
                  lambda x=x: ref.ns_iteration_batched_ref(x))
                  for x in buckets),
              "library_ms": sum(time_ms(lambda x=x: ns_library(x))
                                for x in buckets)}
    # the iteration's three launches apart, per bucket
    parts = {}
    for x in buckets:
        g = syrk_upper(x)
        p = syrk_upper(g, g, alpha=b_, beta=c_)
        parts[str(list(x.shape))] = {
            "gram_ms": time_ms(lambda x=x: syrk_upper(x)),
            "poly_ms": time_ms(lambda g=g: syrk_upper(g, g, alpha=b_,
                                                      beta=c_)),
            "update_ms": time_ms(lambda p=p, x=x: fused_matmul(
                p, x, x, alpha=a_, beta=1.0))}
    emit({"ns_iteration_parts": parts})

    # FLOP the iteration needs per [m, n] slice: the gram XX^T and the
    # poly's A^2 are symmetric, so each needs only its m(m+1)/2 upper dot
    # products (lengths n and m); the update PX is a full GEMM. The kernels
    # execute the T(T+1)/2 upper 128 x 128 tiles of the gram and the poly
    # in full, diagonal tiles included.
    def ns_flop(x, executed: bool) -> int:
        bsz, m, n = x.shape
        t = -(-m // TILE)
        upper = t * (t + 1) * TILE ** 2 if executed else m * (m + 1)
        return bsz * (upper * n + upper * m + 2 * m * m * n)

    def rates(row, needed, executed, nbytes):
        row["bound_ms"], row["bound_by"] = bound_ms(needed, nbytes,
                                                    rate=NS_FLOPS)
        row["bound_ffma_ms"] = bound_ms(needed, nbytes)[0]
        row["effective_tflop_s"] = needed / row["ms"] / 1e9
        row["executed_tflop_s"] = executed / row["ms"] / 1e9
        row["flop_needed"], row["flop_executed"] = needed, executed

    rates(ns_row, sum(ns_flop(x, False) for x in buckets),
          sum(ns_flop(x, True) for x in buckets),
          sum(2 * 4 * x.numel() for x in buckets))

    mm_row = {"name": "fused_matmul", "route": "cuda", "design": NS_DESIGN,
              "source": "src/repro_torch/kernels/csrc/newton_schulz.cu",
              "replaces": "src/repro/kernels/newton_schulz.py:51",
              "max_abs_err": err_mm,
              "ms": sum(time_ms(lambda a=a, b=b, c=c, al=al, be=be:
                                fused_matmul(a, b, c, alpha=al, beta=be))
                        for a, b, c, al, be, _ in mm_main),
              "plain_ms": sum(time_ms(lambda a=a, b=b, c=c, al=al, be=be:
                                      ref.fused_matmul_ref(a, b, c, al, be))
                              for a, b, c, al, be, _ in mm_main),
              "library_ms": sum(time_ms(lambda a=a, b=b, c=c, al=al, be=be:
                                        torch.baddbmm(c, a, b, beta=al,
                                                      alpha=be))
                                for a, b, c, al, be, _ in mm_main)}
    flops = sum(2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
                + 3 * c.numel() for a, b, c, *_ in mm_main)
    rates(mm_row, flops, flops,
          sum(4 * (a.numel() + b.numel() + 2 * c.numel())
              for a, b, c, *_ in mm_main))
    return [ns_row, mm_row]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels.newton_schulz import LAUNCHES, reset_launches
    from repro_torch.launch import train as train_cli

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    # ---- 2. build
    t0 = time.perf_counter()
    libs = build.build_all()
    emit({"build_s": time.perf_counter() - t0,
          "libs": [str(p.relative_to(ROOT)) for p in libs]})

    # ---- 3. kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(0)
    ns_rows = ns_kernel_rows(dev, gen)
    torch.cuda.empty_cache()

    # ---- 3b. the wire's kernels against their plain versions
    from repro_torch.configs import get_config
    from repro_torch.dist.layerwise import LayerPlan
    from repro_torch.models.api import abstract_params, build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("nanogpt-124m")
    plans = {w2s: Trainer(build_model(cfg), TrainerConfig(
        n_workers=2, w2s=w2s), device=dev).layer_plan()
            for w2s in ("top10+natural", "top10")}
    natural_arm = sorted(set(wire_shapes(LayerPlan.build(
        *abstract_params(build_model(cfg)), w2s="natural"))[1]))
    wire_rows = wire_kernel_rows(dev, gen, plans["top10+natural"],
                                 plans["top10"], natural_arm)
    torch.cuda.empty_cache()

    # ---- 4a. end to end on a small input: card vs CPU plain versions
    small_cuda = train_cli.main(SMALL_ARGS + ["--device", "cuda"])
    small_cpu = train_cli.main(SMALL_ARGS + ["--device", "cpu"])
    gap = max(abs(a - b) for a, b in zip(small_cuda["losses"],
                                         small_cpu["losses"]))
    emit({"check": "reduced nanogpt losses, cuda vs cpu",
          "max_abs_diff": gap, "tol": TOL_SLICE_LOSS})
    if not gap <= TOL_SLICE_LOSS:
        fail(f"reduced nanogpt on the card drifts from the CPU run: {gap}")

    # ---- 4b. the main path: nanogpt-124m at full width, 4 steps
    n_buckets = len(plans["top10"].ns_buckets())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = train_cli.main(SLICE_ARGS)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    emit({"slice": "nanogpt-124m", "steps": STEPS, "seq": 1024, "batch": 8,
          "workers": 2, "w2s": "top10", "losses": losses,
          "step_s": out["step_s"], "peak_mem_bytes": peak,
          "ns_buckets": n_buckets, "launches": launches})
    if len(losses) != STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"non-finite or missing losses: {losses}")
    if abs(losses[0] - math.log(cfg.vocab)) > 1.0:
        fail(f"initial loss {losses[0]} far from ln(vocab) "
             f"{math.log(cfg.vocab):.3f}")
    iters = STEPS * NS_STEPS * n_buckets
    if launches["ns_iteration"] != 2 * iters \
            or launches["fused_matmul"] != iters:
        fail(f"NS launches {launches}, expected {2 * iters} ns_iteration "
             f"(gram and poly) and {iters} fused_matmul (update): "
             f"{LAUNCHES_PER_ITERATION * iters} kernel launches")

    # ---- 5. the packed wire through a one-rank NCCL group
    import torch.distributed as dist
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        top10_args = train_cli.parse_args(SLICE_ARGS)
        wire_round_trip(top10_args, group)
        torch.cuda.empty_cache()
        packed = packed_run(top10_args, group, iters)
        gap = max(abs(a - b) for a, b in zip(packed["losses"], losses))
        emit({"check": "packed vs unpacked top10 losses",
              "max_abs_diff": gap, "tol": TOL_PACKED_LOSS,
              "steady_step_s": {"unpacked": out["step_s"][1:],
                                "packed": packed["step_s"][1:]},
              "peak_mem_bytes": {"unpacked": peak,
                                 "packed": packed["peak"]}})
        if not gap <= TOL_PACKED_LOSS:
            fail(f"packed top10 losses drift from the unpacked run: {gap}")
        torch.cuda.empty_cache()
        natural = packed_run(train_cli.parse_args(
            [a if a != "top10" else "top10+natural" for a in SLICE_ARGS]),
            group, iters)
    finally:
        dist.destroy_process_group()

    for r in ns_rows:
        r["launches"] = launches[r["name"]]
    for r in wire_rows:   # each from the packed run that exercises it
        r["launches"] = (natural if r["name"] in (
            "pack_bits", "unpack_bits", "natural_encode", "natural_decode")
                         else packed)["launches"][r["name"]]
        if r["name"] == "unpack_bits":    # its body, on the main path
            r["body_launched_as"] = "natural_decode"
            r["body_launches"] = natural["launches"]["natural_decode"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = ("design", "bound_ffma_ms", "effective_tflop_s",
             "executed_tflop_s", "flop_needed", "flop_executed",
             "fraction_of_bound", "tb_s", "in_step_ms", "copy_ms", "pad_ms",
             "chain_ms", "chain_eager_ms", "kept_outputs_ms",
             "body_launched_as", "body_launches")
    emit({"kernels": [{k: r[k] for k in keys + extra if k in r}
                      for r in ns_rows + wire_rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
