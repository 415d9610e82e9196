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
     x buckets x 3 times (2 symmetric, 1 GEMM); before that, reduced
     nanogpt runs on the card, one-way and two-way (``--s2w natural``),
     must track the same runs on the CPU (plain versions), and so must
     two-way rank10+natural;
  5. the packed wire: the same run through a Trainer over a one-rank
     NCCL group, so phase 4 packs each wire stage into a uint8 buffer and
     all-gathers it — first step 0's payloads through pack -> gather ->
     unpack, bit for bit; then 4 steps with top10 (losses near the
     unpacked run's) and 4 with top10+natural, each checking the
     gathers against the trainer's wire budget and the wire kernels'
     launches against what the layout implies;
  6. the two-way step (EF21-P, ``--s2w``) over the same group: from the
     state after one full-width step (X != W), the server's Natural and
     TopK messages through pack -> broadcast -> unpack -> apply_payload,
     every payload leaf, the new W and the in-place decodes bit for bit
     against the sender's estimate, the sender's cast, Natural encode and
     sign pack (or TopK values and indices) of each lossy leaf against
     the plain versions on the same X - W at the rows the leg gives them
     (embed one row of 38,633,472), the s2w stage buffers packed on the
     card against the plain path's on the CPU; then 4 packed steps with
     ``--w2s top10+natural --s2w natural`` (broadcasts, gathers and every
     kernel's launches against what the layouts imply, peak memory and
     steady steps beside the one-way run's);
  7. the low-rank compressors over the same group: 4 packed steps with
     ``--w2s rank10`` (gathers and launches as for the others: RankK adds
     one NS chain on its sketches per leaf and compress); the server's
     rank10+natural message after one two-way step through pack ->
     broadcast -> unpack -> apply_payload, bit for bit; the sketch NS
     chain at each sketch shape of both directions on that step's real
     sketches, held against the plain chain (or float64, where the plain
     chain is the less exact), one iteration and the gram against
     float64, timed against the cuBLAS chain and its bound; Natural's
     kernels on RankK's real factors bit for bit; 4 packed two-way
     rank10+natural steps; then the two-way natural run and each rank
     run again unpacked through the CLI (losses within TOL_PACKED_LOSS
     of the packed run's, launches as the layouts imply), and 2
     full-width Gluon steps, which launch the NS kernels per slice (their
     chain then held against the plain one on a momentum slice of each
     spectral shape);
  8. the run a user leaves alone, at full width unless said: 4 unpacked
     two-way steps with ``--donate`` (losses bit-equal to the undonated
     run's, launches as the layouts imply, peak no higher); top10 steps
     0-1 with a checkpoint after each, the CLI's ``--resume`` for steps
     2-3 (losses vs phase 4's), the newest generation bit for bit, a
     torn one falling back to ``.prev``, and a two-way rank10+natural
     state round-tripped bit for bit (file bytes, save and load
     seconds); the CLI under ``--supervise`` with a crash fault in a
     subprocess (exit ``CRASH_EXIT``), then resumed to the uninterrupted
     final loss; a stalled step past ``--step-timeout`` (one timeout and
     retry, losses bit-equal, the abandoned attempt waited for); over a
     one-rank NCCL group, packed top10+natural with nan, flip and drop
     faults, then ``round_robin(1)`` (finite losses, participants as
     scheduled, gathers and launches), TopK's decompress of out-of-range
     and negative indices and ``natural_decode`` of all 256 codes vs the
     plain versions, and the same faults on reduced nanogpt, card vs CPU;
     packed two-way with metrics and spans into the JSONL sink (losses,
     bytes and launches unchanged, every metric finite), then one step
     under ``torch.profiler``, its device ms per phase and wire stage;
  9. prints one JSON line of per-kernel numbers, then, as the last line,
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
WIRE_BYTES = {"top10": 66_194_428, "top10+natural": 55_313_394,
              "rank10": 33_841_408, "rank10+natural": 19_102_992}
# the w2s stage buffers of the rank paths, per worker, by stage
# (tests/test_torch_rank.py)
W2S_STAGES = {"rank10": (8_294_656, 14_192_640, 11_354_112),
              "rank10+natural": (4_732_944, 7_983_360, 6_386_688)}
# the s2w stage buffers of nanogpt-124m (one message, lead 1), by stage,
# and the order their broadcasts are issued in (tests/test_torch_s2w.py,
# tests/test_torch_rank.py)
S2W_BYTES = {"natural": (44_500_992, 63_700_992, 31_850_496),
             "top10": (23_726_908, 28_311_600, 14_155_920),
             "rank10+natural": (4_732_944, 7_983_360, 6_386_688)}
S2W_ORDER = (1, 0, 2)
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
# the two-way step: Natural on the server's model update, TopK+Natural on
# the workers' messages
TWO_WAY_ARGS = list(SLICE_ARGS)
TWO_WAY_ARGS[TWO_WAY_ARGS.index("--w2s") + 1] = "top10+natural"
TWO_WAY_ARGS[TWO_WAY_ARGS.index("--s2w") + 1] = "natural"
# the low-rank paths: RankK one way, RankK+Natural both ways
RANK_ARGS = list(SLICE_ARGS)
RANK_ARGS[RANK_ARGS.index("--w2s") + 1] = "rank10"
RANK_TWO_WAY_ARGS = list(SLICE_ARGS)
RANK_TWO_WAY_ARGS[RANK_TWO_WAY_ARGS.index("--w2s") + 1] = "rank10+natural"
RANK_TWO_WAY_ARGS[RANK_TWO_WAY_ARGS.index("--s2w") + 1] = "rank10+natural"
GLUON_STEPS = 2
SMALL_ARGS = ["--arch", "nanogpt-124m", "--reduced", "--steps", "3",
              "--seq", "64", "--batch", "4", "--workers", "2",
              "--log-every", "1"]
# reduced nanogpt card vs CPU: (w2s, s2w)
SMALL_PATHS = (("top10", "identity"), ("top10", "natural"),
               ("rank10+natural", "rank10+natural"))


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


def wire_shapes(plan, direction: str = "w2s"):
    """Row shapes the packed wire gives the wire kernels on nanogpt-124m
    with 2 workers (w2s) or the server's one message (s2w): per narrow
    leaf (rows, k, width, index domain), per Natural leaf (rows, k). One
    launch covers a leaf's rows."""
    import torch
    from repro_torch.wire.codecs import NarrowIntCodec
    layout = plan.wire_layout(torch.bfloat16, direction)
    narrow, natural = [], []
    for lp, spec in zip(plan.leaves, layout.specs):
        rows = (2 if direction == "w2s" else 1) * spec.n_stack
        for name, c in zip(spec.names, spec.codecs):
            if isinstance(c, NarrowIntCodec):
                narrow.append((rows, c.shape[0], c.width,
                               math.prod(lp.slice_shape)))
            if name and name.endswith("codes"):
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


def expected_launches(tr, n_ns_iters: int, packed: bool,
                      steps: int = STEPS) -> dict:
    """Every kernel's launches over ``steps`` steps of ``tr``'s run, from its
    layouts. One cast of each EF21 difference per lossy leaf; the narrow
    encode in pack and decode in unpack, one launch per leaf and
    direction (packed only); Natural encodes and packs signs once per
    Natural leaf (``codes``, ``values_codes``, ``p_codes``, ...) in
    compress, and decodes codes and packed signs in one natural_decode
    launch in each decompress: w2s twice (the sender's EF21 estimate and
    the server's fold), s2w once (the receivers' apply_payload; the
    packed sender compresses only, and the unpacked one takes its
    estimate from that one decode). unpack_bits' body runs there, its
    bits epilogue never. RankK adds to each compress one NS chain of
    NS_STEPS iterations on its sketches (one batched launch chain per
    leaf) and the casts of its two factors. A compressing s2w leg also
    casts W to the params' dtype for the gradients, once per leaf.
    ``n_ns_iters`` counts the LMO's NS iterations."""
    import torch
    from repro_torch.core.compressors import RankK
    from repro_torch.dist.layerwise import tree_leaves
    plan = tr.layer_plan()
    two_way = tr.opt.cfg.s2w != "identity"
    directions = ("w2s", "s2w") if two_way else ("w2s",)
    narrow, natural = wire_shapes(plan)
    narrow_s, natural_s = wire_shapes(plan, "s2w") if two_way else ([], [])
    n_narrow = len(narrow) + len(narrow_s) if packed else 0
    comps = [getattr(lp, d) for lp in plan.leaves for d in directions]
    n_lossy = sum(not getattr(c, "lossless_wire", False) for c in comps)
    n_rank = sum(isinstance(getattr(c, "inner", c), RankK) for c in comps)
    n_cast = sum(p.dtype == torch.bfloat16
                 for p in tree_leaves(tr._params_shapes)) if two_way else 0
    n_ns = n_ns_iters + steps * NS_STEPS * n_rank
    return {"ns_iteration": 2 * n_ns, "fused_matmul": n_ns,
            "to_bf16": steps * (n_lossy + 2 * n_rank + n_cast),
            "narrow_encode": steps * n_narrow,
            "narrow_decode": steps * n_narrow,
            "natural_encode": steps * (len(natural) + len(natural_s)),
            "pack_bits": steps * (len(natural) + len(natural_s)),
            "natural_decode": steps * (2 * len(natural) + len(natural_s)),
            "unpack_bits": 0}


def unpacked_run(argv, n_ns_iters: int, packed: dict) -> dict:
    """The run of ``argv`` through the CLI (no group, so no wire): its
    losses within TOL_PACKED_LOSS of the ``packed`` run's, every kernel's
    launches as the layouts imply with nothing packed."""
    import torch
    from repro_torch.launch import train as train_cli
    args = train_cli.parse_args(argv)
    _, tr, _, _ = train_cli.setup(args)
    want = expected_launches(tr, n_ns_iters, packed=False)
    del tr
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    out = train_cli.main(argv)
    torch.cuda.synchronize()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    gap = max(abs(a - b) for a, b in zip(packed["losses"], out["losses"]))
    tag = f"{args.w2s} / s2w {args.s2w}"
    emit({"check": f"packed vs unpacked {tag} losses", "max_abs_diff": gap,
          "tol": TOL_PACKED_LOSS, "unpacked_losses": out["losses"],
          "unpacked_launches": launches, "unpacked_peak_mem_bytes": peak})
    if len(out["losses"]) != STEPS or not gap <= TOL_PACKED_LOSS:
        fail(f"{tag} packed losses drift from the unpacked run's: {gap}")
    if launches != want:
        fail(f"unpacked {tag} launches {launches}, the layouts imply {want}")
    torch.cuda.empty_cache()
    return {"losses": out["losses"], "step_s": out["step_s"], "peak": peak,
            "launches": launches}


def packed_run(args, group, n_ns_iters: int) -> dict:
    """4 full-width steps through a Trainer over ``group``: checks the
    losses, the gathers (and, with a compressing ``--s2w``, the
    broadcasts) against the wire budget and every kernel's launches
    against what the layouts imply."""
    import torch
    from repro_torch.launch import train as train_cli
    cfg, tr, data, sched = train_cli.setup(args, group=group)
    budget = tr.wire_budget()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    out = train_cli.run_steps(tr, tr.init(args.seed), data, sched, STEPS)
    torch.cuda.synchronize()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    tag = f"{args.w2s} / s2w {args.s2w}"
    emit({"packed": args.w2s, "s2w": args.s2w, "steps": STEPS,
          "losses": losses, "step_s": out["step_s"], "peak_mem_bytes": peak,
          "gathers_per_step": len(tr.gathered) / STEPS,
          "gathered_bytes_per_step": sum(tr.gathered) / STEPS,
          "broadcasts_per_step": len(tr.broadcast_bytes) / STEPS,
          "broadcast_bytes_per_step": sum(tr.broadcast_bytes) / STEPS,
          "w2s_sizes": budget.w2s_sizes, "s2w_sizes": budget.s2w_sizes,
          "launches": launches})
    if len(losses) != STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"{tag} packed run: non-finite or missing losses {losses}")
    if abs(losses[0] - math.log(cfg.vocab)) > 1.0:
        fail(f"{tag} packed run: initial loss {losses[0]} far from "
             f"ln(vocab) {math.log(cfg.vocab):.3f}")
    if budget.w2s_nbytes != WIRE_BYTES[args.w2s] or budget.n_stages != 3 \
            or budget.w2s_sizes != W2S_STAGES.get(args.w2s,
                                                  budget.w2s_sizes):
        fail(f"{tag} wire budget {budget}")
    if tr.gathered != [2 * s for s in budget.w2s_sizes] * STEPS:
        fail(f"{tag} gathers {tr.gathered}, expected "
             f"{[2 * s for s in budget.w2s_sizes]} per step")
    want_bc = ([S2W_BYTES[args.s2w][k] for k in S2W_ORDER]
               if args.s2w != "identity" else [])
    if budget.s2w_sizes != S2W_BYTES.get(args.s2w, ()) \
            or tr.broadcast_bytes != want_bc * STEPS:
        fail(f"{tag} broadcasts {tr.broadcast_bytes} (budget "
             f"{budget.s2w_sizes}), expected {want_bc} per step")
    want = expected_launches(tr, n_ns_iters, packed=True)
    if launches != want:
        fail(f"{tag} launches {launches}, the layouts imply {want}")
    return {"losses": losses, "step_s": out["step_s"], "peak": peak,
            "launches": launches, "gathered": tr.gathered,
            "broadcast_bytes": tr.broadcast_bytes}


def natural_plain_check(tag: str, rows, codes, signs) -> None:
    """Natural's kernels on ``rows`` (``[*lead, n]`` bf16) as the sender
    ran them (``codes``, ``signs``: natural_encode, then pack_bits)
    against the plain versions, bit for bit, and natural_decode of them
    against its plain version."""
    import torch
    from repro_torch.kernels import bitpack as bp
    from repro_torch.kernels import ref
    want_c, signs01 = ref.natural_compress_ref(rows)
    check_equal(f"{tag}: natural_encode codes {list(codes.shape)} vs the "
                "plain path", codes, want_c)
    check_equal(f"{tag}: pack_bits signs {list(signs.shape)} vs the plain "
                "path", signs, bp.pack_bits_ref(signs01))
    check_equal(f"{tag}: natural_decode {list(codes.shape)} vs the plain "
                "path", bp.natural_decode(codes, signs).view(torch.int16),
                bp.natural_decode_ref(codes, signs).view(torch.int16))


def s2w_plain_check(tag: str, lp, cs, w, x, payload) -> int:
    """One lossy leaf's s2w compress as the sender ran it against the
    plain versions on the same X - W on the card, at the rows the leg
    hands the kernels (``[*stack, n]``): the cast, then Natural's encode
    and sign pack, TopK's sort of the cast values, or RankK's factors
    (from the NS kernels, made again from the same sketches ``cs``), each
    through Natural's kernels. Returns the slice's n."""
    import torch
    from repro_torch.kernels import bitpack as bp
    from repro_torch.kernels import ref
    from repro_torch.kernels.natural_pack import to_bf16
    # contiguous, as ef_compress writes it (a leaf of x may be a
    # transposed view)
    diff = (x.to(torch.float32) - w.to(torch.float32)).contiguous()
    bf = ref.to_bf16_ref(diff)
    check_equal(f"{tag}: to_bf16 of X - W {list(diff.shape)}",
                to_bf16(diff).view(torch.int16), bf.view(torch.int16))
    n = math.prod(lp.slice_shape)
    lead = bf.shape[:bf.ndim - len(lp.slice_shape)]
    if "p_codes" in payload:
        factors, _ = lp.s2w.inner.compress(cs, bf, lp.slice_shape)
        for name, f in factors.items():
            natural_plain_check(f"{tag}: RankK {name}",
                                f.reshape(lead + (-1,)),
                                payload[name + "_codes"],
                                payload[name + "_signs"])
        return n
    if set(payload) == {"codes", "signs"}:
        codes, signs01 = ref.natural_compress_ref(bf.reshape(lead + (n,)))
        want = {"codes": codes, "signs": bp.pack_bits_ref(signs01)}
    else:
        want, _ = lp.s2w.compress({}, bf, lp.slice_shape)
    for name, b in want.items():
        a = payload[name]
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        check_equal(f"{tag}: {name} {list(a.shape)} vs the plain path", a,
                    b)
    return n


def s2w_round_trip(group, args=TWO_WAY_ARGS,
                   names=("natural", "top10")) -> tuple:
    """From the state after one full-width two-way step of ``args`` (X !=
    W), the server's message under each s2w compressor of ``names``
    through each stage's pack -> broadcast -> unpack, in issue order:
    every payload leaf comes back bit for bit, and apply_payload of it
    gives the sender's ef_compress_step estimate bit for bit. The stage
    buffers packed on the card equal the plain path's pack of the same
    payloads on the CPU, and each Natural leaf's decode in place (the
    [n_stack, n] views of a [1, nbytes] stage buffer that apply_payload
    hands it; embed is one row of 38,633,472) equals the plain decode of
    the same views. Each lossy leaf's payload, made by the kernels on
    the card, equals the plain versions' on the same X - W
    (``s2w_plain_check``). A compressor that keeps state (RankK) starts
    from fresh sketches: the step's own are zero, as the reference's are
    (the first message, C(X - W) with X = W, has the sketch Qn = 0, and
    RankK's next sketch is X^T P = 0 whatever X - W). Returns the trainer
    and the state after the step."""
    import torch
    from repro_torch.core.error_feedback import apply_payload, ef_compress_step
    from repro_torch.dist.layerwise import LayerPlan
    from repro_torch.dist.pipeline import s2w_issue_order
    from repro_torch.kernels import bitpack as bp
    from repro_torch.launch import train as train_cli
    from repro_torch.wire.codecs import flatten_payload, unflatten_payload
    _, tr, data, sched = train_cli.setup(train_cli.parse_args(args),
                                         group=group)
    state, _ = tr.make_step()(tr.init(0), data.batch_at(0), sched(1))
    cfg = tr.opt.cfg
    for s2w in names:
        plan = LayerPlan.build(tr._params_shapes, tr.metas, w2s=cfg.w2s,
                               s2w=s2w)
        x_f, w_f = plan.flatten(state["x"]), plan.flatten(state["w"])
        gen = torch.Generator().manual_seed(1)
        states = [lp.s2w.init(gen, lp.slice_shape, cfg.wire_dtype,
                              lp.stack_shape, x.device)
                  for lp, x in zip(plan.leaves, x_f)]
        sent, w_want, rows = [], [], []
        for i, (lp, cs, w, x) in enumerate(zip(plan.leaves, states, w_f,
                                               x_f)):
            pl, _, w_new = ef_compress_step(lp.s2w, cs, w, x, lp.slice_shape,
                                            cfg.wire_dtype)
            if not getattr(lp.s2w, "lossless_wire", False):
                rows.append(s2w_plain_check(f"s2w {s2w} compress, leaf {i}",
                                            lp, cs, w, x, pl))
            sent.append(flatten_payload(pl))
            w_want.append(w_new)
        if all(torch.equal(a, b) for a, b in zip(w_want, w_f)):
            fail(f"s2w {s2w} round trip: the message is zero (X == W)")
        lead = [unflatten_payload(n, [a[None] for a in ls]) for n, ls in sent]
        splan = plan.stage_plan()
        sw = plan.staged_wire_layout(cfg.wire_dtype, splan, "s2w")
        order = s2w_issue_order(plan, splan)
        tr.broadcast_bytes.clear()
        n_leaves = 0
        for k in order:
            buf = sw.pack_stage(k, lead)
            cpu = sw.pack_stage(k, [unflatten_payload(
                n, [a.cpu()[None] for a in ls]) for n, ls in sent])
            check_equal(f"s2w {s2w} stage {k} {list(buf.shape)} packed on "
                        "the card vs the plain path on the CPU", buf.cpu(),
                        cpu)
            del cpu
            for i, pl in zip(sw.stage_leaf_ids[k],
                             sw.unpack_stage(k, tr._broadcast(buf))):
                names_i, got = flatten_payload(pl)
                got = [a[0] for a in got]
                for name, a, b in zip(names_i, got, sent[i][1]):
                    if a.dtype != b.dtype or not torch.equal(a, b):
                        fail(f"s2w {s2w} round trip: leaf {i} payload {name} "
                             "changed through pack -> broadcast -> unpack")
                leaves = dict(zip(names_i, got))
                for name in names_i:
                    if not (name and name.endswith("codes")):
                        continue
                    codes = leaves[name]
                    signs = leaves[name[:-len("codes")] + "signs"]
                    check_equal(
                        f"natural_decode in place, s2w stage {k} leaf {i} "
                        f"{name} {list(codes.shape)} at byte "
                        f"{codes.storage_offset()}, signs at byte "
                        f"{signs.storage_offset()}",
                        bp.natural_decode(codes, signs).view(torch.int16),
                        bp.natural_decode_ref(codes, signs)
                        .view(torch.int16))
                w_got = apply_payload(plan.leaves[i].s2w,
                                      unflatten_payload(names_i, got),
                                      w_f[i])
                check_equal(f"s2w {s2w} leaf {i}: W from the wire vs the "
                            "sender's estimate", w_got.view(torch.int32),
                            w_want[i].view(torch.int32))
                n_leaves += 1
            del buf
        if tr.broadcast_bytes != [S2W_BYTES[s2w][k] for k in S2W_ORDER] \
                or tuple(order) != S2W_ORDER:
            fail(f"s2w {s2w} round trip: broadcasts {tr.broadcast_bytes} in "
                 f"order {order}, expected {S2W_ORDER} of {S2W_BYTES[s2w]}")
        torch.cuda.synchronize()
        emit({"check": f"the server's {s2w} message after one step through "
              "the s2w wire", "stages": sw.n_stages, "leaves": n_leaves,
              "issue_order": order, "bytes_broadcast": tr.broadcast_bytes,
              "lossy_leaves_vs_plain": len(rows), "longest_row": max(rows),
              "bit_equal": True})
        del sent, w_want, lead
        torch.cuda.empty_cache()
    return tr, state


def rank_sketch_rows(tr, state) -> list[dict]:
    """RankK's sketch Newton-Schulz and its factors' Natural kernels on
    the real sketches of one step of ``tr`` (two-way rank10+natural),
    from ``state``: per lossy leaf and direction, the difference RankK
    would compress next (w2s: M - G over both workers, s2w: X - W), cast
    to bf16, times its sketch Q (w2s: the step's; s2w: a fresh draw, the
    step's being zero), transposed to ``[L, r, m]`` as RankK hands it to
    the NS chain. Each sketch's chain on the card against the plain
    chain within TOL_NS_CHAIN, or, where the plain chain is itself
    further than that from a float64 chain (cuBLAS f32 sums embed's gram
    over 50,304 terms), against the float64 chain; one iteration and the
    gram against float64 within TOL_ONE_PASS; per shape the chain's time (kernels, plain, cuBLAS f32:
    ``bmm`` + 2 ``baddbmm`` an iteration) and its bound (operations over
    the 3xTF32 peak, or bytes). Then RankK's w2s factors, ``p`` and
    ``q``, through natural_encode, pack_bits and natural_decode against
    their plain versions, bit for bit (the s2w factors are held in
    ``s2w_round_trip``)."""
    import torch
    from repro_torch.core.error_feedback import cast
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.newton_schulz import ns_iteration, syrk_upper
    from repro_torch.kernels.ops import natural_compress
    a_, b_, c_ = ref.NS_COEFFS
    plan = tr.layer_plan()
    flat = {k: plan.flatten(state[k]) for k in ("x", "w", "m_w", "g_w")}
    timed, rows = set(), []
    # the step's s2w sketches are zero, as the reference's (the first
    # message had X = W, so its Qn = 0, and every later one is too):
    # the s2w sketches below are fresh draws at the same shapes
    zero = [i for i, cs in enumerate(state["cs_state"])
            if "q" in cs and not bool(cs["q"].any())]
    emit({"rank_s2w_sketches_zero_after_one_step": zero})
    gen = torch.Generator().manual_seed(1)
    fresh = [lp.s2w.init(gen, lp.slice_shape, torch.bfloat16,
                         lp.stack_shape, x.device)
             for lp, x in zip(plan.leaves, flat["x"])]

    def rel_err(got, want):
        return ((got.double() - want).abs().max()
                / want.abs().max()).item()

    def f64_chain(x):
        x = x.double()
        x = x / (x.flatten(1).norm(dim=1)[:, None, None] + 1e-7)
        for _ in range(NS_STEPS):
            g = x @ x.mT
            x = a_ * x + (b_ * g + c_ * g @ g) @ x
        return x

    def cublas_chain(x):
        nrm = torch.sqrt(torch.sum(torch.square(x), dim=(-2, -1),
                                   keepdim=True))
        x = x / (nrm + 1e-7)
        for _ in range(NS_STEPS):
            g = torch.bmm(x, x.mT)
            x = torch.baddbmm(x, torch.baddbmm(g, g, g, beta=b_, alpha=c_),
                              x, beta=a_)
        return x

    for i, lp in enumerate(plan.leaves):
        for direction, target, est, cst in (
                ("w2s", flat["m_w"][i], flat["g_w"][i],
                 state["cw_state"][i]),
                ("s2w", flat["x"][i], flat["w"][i], fresh[i])):
            if "q" not in cst:
                continue
            m, n = lp.slice_shape
            r = cst["q"].shape[-1]
            diff = cast((target.to(torch.float32)
                         - est.to(torch.float32)).contiguous(),
                        torch.bfloat16)
            p = torch.bmm(diff.to(torch.float32).reshape(-1, m, n),
                          cst["q"].to(torch.float32).reshape(-1, n, r))
            x = p.mT.contiguous()
            tag = f"RankK sketch, {direction} leaf {i} {list(x.shape)}"
            got = ops.newton_schulz_batched(x, steps=NS_STEPS)
            plain = ref.newton_schulz_batched_ref(x, steps=NS_STEPS)
            exact = f64_chain(x)
            plain_err = rel_err(plain, exact)
            emit({"measure": f"{tag}: the chains' distances",
                  "plain_vs_float64": plain_err,
                  "kernels_vs_float64": rel_err(got, exact),
                  "kernels_vs_plain": rel_err(got, plain.double())})
            if plain_err <= TOL_NS_CHAIN:
                err = check(f"{tag}: NS kernels vs the plain chain", got,
                            plain, TOL_NS_CHAIN)
            else:
                # the plain chain is the less exact of the two here:
                # hold the kernels against the float64 chain instead
                err = check(f"{tag}: NS kernels vs the float64 chain (the "
                            "plain chain is further off it than the "
                            "tolerance)", got, exact, TOL_NS_CHAIN)
            del got, plain, exact
            xn = x / x.flatten(1).norm(dim=1)[:, None, None]
            xd = xn.double()
            g = xd @ xd.mT
            one = a_ * xd + (b_ * g + c_ * g @ g) @ xd
            check(f"{tag}: one NS iteration vs float64", ns_iteration(xn),
                  one, TOL_ONE_PASS)
            emit({"measure": f"{tag}: one plain f32 iteration vs float64",
                  "rel_err": rel_err(ref.ns_iteration_batched_ref(xn),
                                     one)})
            check(f"{tag}: gram vs float64", syrk_upper(xn), g,
                  TOL_ONE_PASS)
            del xd, g, one
            if direction == "w2s":
                lead = diff.shape[:diff.ndim - 2]
                factors, _ = lp.w2s.inner.compress(cst, diff, lp.slice_shape)
                for name, f in factors.items():
                    fr = f.reshape(lead + (-1,))
                    natural_plain_check(f"RankK w2s leaf {i} {name}", fr,
                                        *natural_compress(fr))
            key = (direction, tuple(x.shape))
            if key in timed:
                continue
            timed.add(key)
            bsz = x.shape[0]
            # an iteration over [L, r, m]: the gram's and the poly's r(r+1)/2
            # upper dot products (lengths m and r), the update's full GEMM
            flop = NS_STEPS * bsz * (r * (r + 1) * m + r * (r + 1) * r
                                     + 2 * r * r * m)
            nbytes = NS_STEPS * 2 * 4 * x.numel()
            bound, by = bound_ms(flop, nbytes, rate=NS_FLOPS)
            row = {"direction": direction, "shape": list(x.shape),
                   "leaf": i, "max_abs_err": err,
                   "ms": time_ms(lambda x=x: ops.newton_schulz_batched(
                       x, steps=NS_STEPS), reps=10),
                   "plain_ms": time_ms(lambda x=x: ref.newton_schulz_batched_ref(
                       x, steps=NS_STEPS), reps=10),
                   "library_ms": time_ms(lambda x=x: cublas_chain(x),
                                         reps=10),
                   "bound_ms": bound, "bound_by": by, "flop": flop}
            row["fraction_of_bound"] = bound / row["ms"]
            rows.append(row)
            emit({"rank_sketch_ns": row})
    return rows


def gluon_run(dev, cfg) -> dict:
    """GLUON_STEPS full-width Gluon steps (the uncompressed baseline, one
    worker, seq 1024, batch 8): finite losses, the first near ln(vocab),
    and the NS kernels launched once per spectral slice and iteration.
    Then the LMO's NS chain on one slice of each spectral shape of the
    last step's momentum (what gluon_update handed the kernels) against
    the plain chain, within TOL_NS_CHAIN."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.gluon import gluon_init, gluon_update
    from repro_torch.core.lmo import lmo_direction
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.dist.layerwise import tree_leaves
    from repro_torch.kernels import ref
    from repro_torch.models.api import build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tr = Trainer(build_model(cfg), TrainerConfig(), device=dev)
    params, metas = tr.model.init(torch.Generator().manual_seed(0), dev)
    data = SyntheticLM(cfg, ShapeSpec("gluon", "train", 1024, 8),
                       n_workers=1, seed=0, device=dev)
    opt_state = gluon_init(params)
    n_slices = sum(math.prod(p.shape[:m.stack_dims])
                   for p, m in zip(tree_leaves(params), tree_leaves(metas))
                   if m.lmo == "spectral")
    torch.cuda.synchronize()
    reset_all_launches()
    losses, step_s = [], []
    for i in range(GLUON_STEPS):
        t0 = time.perf_counter()
        loss, grads = tr._grad_and_loss(params, {
            k: v[0] for k, v in data.batch_at(i).items()})
        params, opt_state = gluon_update(params, grads, opt_state, metas,
                                         0.01, beta=0.5, ns_steps=NS_STEPS)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = all_launches()
    iters = GLUON_STEPS * n_slices * NS_STEPS
    want = {k: 0 for k in launches}
    want.update(ns_iteration=2 * iters, fused_matmul=iters)
    emit({"gluon": cfg.name, "steps": GLUON_STEPS, "losses": losses,
          "step_s": step_s, "spectral_slices": n_slices,
          "launches": launches})
    if not all(math.isfinite(v) for v in losses) \
            or abs(losses[0] - math.log(cfg.vocab)) > 1.0:
        fail(f"Gluon losses {losses}")
    if launches != want:
        fail(f"Gluon launches {launches}, expected {want}")
    shapes = set()
    for m, meta in zip(tree_leaves(opt_state["m"]), tree_leaves(metas)):
        g = m[(0,) * meta.stack_dims]
        if meta.lmo == "spectral" and tuple(g.shape) not in shapes:
            shapes.add(tuple(g.shape))
            check(f"Gluon LMO on a {list(g.shape)} momentum slice: NS "
                  "kernels vs the plain chain",
                  lmo_direction(g, "spectral", ns_steps=NS_STEPS),
                  -ref.newton_schulz_ref(g, NS_STEPS), TOL_NS_CHAIN)
    return {"losses": losses, "launches": launches}


# ------------------------------------------------------------- phase 8
# the unpacked two-way run's peak as recorded in PERF.md §5 before the
# step could update its state in place (one H100 SXM at 700 W)
PEAK_TWO_WAY_UNPACKED_RECORDED = 18_553_324_032
FAULTS = "nan:w=0:steps=2,flip:steps=3:bits=64,drop:w=1:steps=4"
FAULT_STEPS, ELASTIC_STEPS = 6, 4
# reduced nanogpt's participation table for the card-vs-CPU fault run
EXPLICIT_MASKS = ((1, 1), (1, 1), (1, 0), (1, 1), (0, 1), (1, 1))
STALL_TIMEOUT_S, STALL_MS = 2.0, 4000
SPAN_TOL = 0.10          # phase spans' device ms vs the step's busy time


def phase8_dir() -> Path:
    d = ROOT / "build" / "chip_smoke_phase8"
    d.mkdir(parents=True, exist_ok=True)
    return d


def same_state(a, b) -> bool:
    """Bit for bit: every tensor of two optimizer states (bf16 and f32 as
    their integer patterns), the compressor-state lists and the step."""
    import torch
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            same_state(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same_state(u, v)
                                        for u, v in zip(a, b))
    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        bits = {2: torch.int16, 4: torch.int32}.get(a.element_size())
        return torch.equal(a.view(bits), b.view(bits)) if bits \
            else torch.equal(a, b)
    return a == b


def donate_run(undonated: dict, n_ns_iters: int) -> dict:
    """8.1: the unpacked two-way run with --donate: losses bit-equal to
    the undonated run's, launches as the layouts imply, peak no higher
    than the undonated run's or the recorded one."""
    import torch
    from repro_torch.launch import train as train_cli
    argv = TWO_WAY_ARGS + ["--donate"]
    _, tr, _, _ = train_cli.setup(train_cli.parse_args(argv))
    want = expected_launches(tr, n_ns_iters, packed=False)
    del tr
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    out = train_cli.main(argv)
    torch.cuda.synchronize()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "8.1 donate", "losses": out["losses"],
          "undonated_losses": undonated["losses"],
          "step_s": out["step_s"], "undonated_step_s": undonated["step_s"],
          "peak_mem_bytes": peak, "undonated_peak_mem_bytes":
          undonated["peak"], "recorded_undonated_peak_mem_bytes":
          PEAK_TWO_WAY_UNPACKED_RECORDED, "launches": launches})
    if out["losses"] != undonated["losses"]:
        fail(f"--donate losses {out['losses']} are not bit-equal to the "
             f"undonated run's {undonated['losses']}")
    if launches != want:
        fail(f"--donate launches {launches}, the layouts imply {want}")
    if peak > min(undonated["peak"], PEAK_TWO_WAY_UNPACKED_RECORDED):
        fail(f"--donate peak {peak} B above the undonated run's "
             f"{undonated['peak']} B or the recorded "
             f"{PEAK_TWO_WAY_UNPACKED_RECORDED} B")
    torch.cuda.empty_cache()
    return {"peak": peak, "losses": out["losses"]}


def checkpoint_run(base: dict) -> dict:
    """8.2: top10 steps 0-1, a checkpoint after each, then the CLI's
    --resume for steps 2-3 (losses vs phase 4b's, TOL_PACKED_LOSS); the
    newest generation loads bit for bit, and truncated it falls back to
    .prev with a warning; then a two-way rank10+natural state after one
    step round-trips bit for bit."""
    import os
    import warnings
    import torch
    from repro_torch.launch import train as train_cli
    from repro_torch.train.checkpoint import (load_checkpoint,
                                              save_checkpoint,
                                              state_template)
    path = str(phase8_dir() / "top10")
    args = train_cli.parse_args(SLICE_ARGS)
    _, tr, data, sched = train_cli.setup(args)
    s1 = train_cli.run_steps(tr, tr.init(args.seed), data, sched, 1)["state"]
    save_checkpoint(path, s1, step=1)
    s2 = train_cli.run_steps(tr, s1, data, sched, 2, start=1)["state"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(path, s2, step=2)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path + ".npz")
    t0 = time.perf_counter()
    got, step = load_checkpoint(path, state_template(s2))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if step != 2 or not same_state(got, s2):
        fail("checkpoint: the loaded state is not the saved one bit for bit")
    del got, s2
    torch.cuda.empty_cache()
    resumed = train_cli.main(SLICE_ARGS + ["--resume", path])
    gap = max(abs(a - b) for a, b in zip(resumed["losses"],
                                         base["losses"][2:]))
    with open(path + ".npz", "r+b") as f:   # a torn write of the newest
        f.truncate(nbytes // 2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        prev, pstep = load_checkpoint(path, state_template(s1))
    fell_back = any("falling back" in str(w.message) for w in caught)
    if not fell_back or pstep != 1 or not same_state(prev, s1):
        fail(f"checkpoint: a torn newest generation did not fall back to "
             f"the .prev state (warned {fell_back}, step {pstep})")
    del prev, s1
    torch.cuda.empty_cache()
    rpath = str(phase8_dir() / "rank10_two_way")
    rargs = train_cli.parse_args(RANK_TWO_WAY_ARGS)
    _, rtr, rdata, rsched = train_cli.setup(rargs)
    rstate = train_cli.run_steps(rtr, rtr.init(rargs.seed), rdata, rsched,
                                 1)["state"]
    save_checkpoint(rpath, rstate, step=1)
    rgot, rstep = load_checkpoint(rpath, state_template(rstate))
    n_q = sum(bool(cs) for cs in rstate["cw_state"] + rstate["cs_state"])
    if rstep != 1 or n_q == 0 or not same_state(rgot, rstate):
        fail("checkpoint: the two-way rank10+natural state did not "
             "round-trip bit for bit")
    rbytes = os.path.getsize(rpath + ".npz")
    del rgot, rstate
    for p in (path + ".npz", path + ".npz.prev", rpath + ".npz"):
        os.remove(p)
    torch.cuda.empty_cache()
    emit({"phase": "8.2 checkpoint", "file_bytes": nbytes,
          "save_s": save_s, "load_s": load_s,
          "resumed_losses": resumed["losses"],
          "uninterrupted_losses": base["losses"][2:],
          "max_abs_diff": gap, "tol": TOL_PACKED_LOSS,
          "torn_newest_fell_back_to_prev": True,
          "rank10_two_way_file_bytes": rbytes, "rank10_sketch_states": n_q,
          "rank10_two_way_bit_equal": True})
    if len(resumed["losses"]) != 2 or not gap <= TOL_PACKED_LOSS:
        fail(f"checkpoint: resumed losses drift from the uninterrupted "
             f"run's: {gap}")
    return {"file_bytes": nbytes, "save_s": save_s, "load_s": load_s}


def crash_run(base: dict) -> None:
    """8.3: the CLI under the supervisor with a periodic checkpoint and a
    crash fault, in a subprocess: it exits with CRASH_EXIT; the --resume
    run finishes with the uninterrupted run's final loss."""
    import os
    from repro_torch.launch import train as train_cli
    from repro_torch.train.faults import CRASH_EXIT
    path = str(phase8_dir() / "crash")
    extra = ["--supervise", "--checkpoint", path, "--checkpoint-every",
             "2", "--faults", "crash:step=2"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *SLICE_ARGS, *extra], env=env, cwd=str(ROOT),
                       capture_output=True, text=True, timeout=600)
    crash_s = time.perf_counter() - t0
    if r.returncode != CRASH_EXIT:
        fail(f"crash run exited {r.returncode}, not {CRASH_EXIT}: "
             f"{r.stderr[-2000:]}")
    resumed = train_cli.main(SLICE_ARGS + extra + ["--resume", path])
    gap = abs(resumed["losses"][-1] - base["losses"][-1])
    for p in (path + ".npz", path + ".npz.prev"):
        if os.path.exists(p):
            os.remove(p)
    emit({"phase": "8.3 crash and resume", "exit_code": r.returncode,
          "crash_run_s": crash_s, "resumed_losses": resumed["losses"],
          "uninterrupted_final_loss": base["losses"][-1],
          "max_abs_diff": gap, "tol": TOL_PACKED_LOSS})
    if len(resumed["losses"]) != 2 or not gap <= TOL_PACKED_LOSS:
        fail(f"crash: the resumed run's final loss drifts from the "
             f"uninterrupted run's: {gap}")


def stall_run(base: dict) -> dict:
    """8.4: a stalled step under the supervisor's watchdog: one timeout,
    one retry, losses bit-equal to the unsupervised run; the abandoned
    attempt is waited for before anything resets the launch counters."""
    import contextlib
    import io
    import threading
    import torch
    from repro_torch.launch import train as train_cli
    argv = SLICE_ARGS + ["--supervise", "--step-timeout",
                         str(STALL_TIMEOUT_S), "--faults",
                         f"stall:w=0:steps=1:ms={STALL_MS}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_cli.main(argv)
    print(buf.getvalue(), end="", flush=True)
    for th in threading.enumerate():
        if th.name == "supervised-step":
            th.join(timeout=300)
            if th.is_alive():
                fail("the abandoned supervised attempt did not finish")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    line = [x for x in buf.getvalue().splitlines()
            if x.startswith("RESYNC_SUMMARY ")]
    summary = json.loads(line[-1].split(" ", 1)[1]) if line else {}
    emit({"phase": "8.4 supervisor timeout", "step_timeout_s":
          STALL_TIMEOUT_S, "stall_ms": STALL_MS, "losses": out["losses"],
          "unsupervised_losses": base["losses"], "step_s": out["step_s"],
          "summary": summary, "peak_mem_bytes_with_abandoned_attempt": peak})
    if summary.get("supervisor_retries") != 1:
        fail(f"stall: expected one timeout and one retry, got {summary}")
    if out["losses"] != base["losses"]:
        fail(f"stall: supervised losses {out['losses']} are not bit-equal "
             f"to the unsupervised run's {base['losses']}")
    torch.cuda.empty_cache()
    return {"peak": peak}


def scatter_and_codes_check(dev) -> None:
    """TopK's decompress with out-of-range and negative indices, and
    natural_decode on all 256 codes x both signs, on the card against the
    plain versions (the same calls on the CPU)."""
    import torch
    from repro_torch.core.compressors import TopK
    from repro_torch.kernels import bitpack as bp
    n = 1000
    # distinct after the wrap (the card's scatter promises no order among
    # repeated indices): -1 -> 999, -1000 -> 0; 1000, 2**23, -1001 drop
    idx = torch.tensor([[3, -1, 1000, -1000, 2 ** 23, -1001, 7, 998]] * 2,
                       dtype=torch.int32)
    vals = torch.arange(1, 17, dtype=torch.float32).reshape(2, 8).to(
        torch.bfloat16)
    pl = {"values": vals, "indices": idx}
    want = TopK(0.1).decompress(pl, (2, n), torch.float32)
    got = TopK(0.1).decompress({k: v.to(dev) for k, v in pl.items()},
                               (2, n), torch.float32)
    check_equal("TopK decompress, out-of-range and negative indices, card "
                "vs CPU", got.cpu().view(torch.int32), want.view(torch.int32))
    codes = torch.arange(256, dtype=torch.uint8).repeat(2)[None].to(dev)
    signs = bp.pack_bits_ref(torch.cat([torch.zeros(256), torch.ones(256)])
                             .to(torch.uint8)[None]).to(dev)
    check_equal("natural_decode, all 256 codes x 2 signs",
                bp.natural_decode(codes, signs).view(torch.int16),
                bp.natural_decode_ref(codes, signs).view(torch.int16))


def fault_run(group, n_buckets: int) -> dict:
    """8.5: the packed top10+natural run with nan, flip and drop faults
    for FAULT_STEPS steps, then ELASTIC_STEPS under round_robin(1):
    finite losses, the scheduled participants (the NaN worker demoted),
    the gathers of the budget, the launches the layouts imply; then the
    same faults on reduced nanogpt (top10, an Explicit table) on the
    card and on the CPU, losses within TOL_SLICE_LOSS."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.dist.participation import Explicit
    from repro_torch.launch import train as train_cli
    from repro_torch.models.api import build_model
    from repro_torch.train.faults import parse_faults
    from repro_torch.train.trainer import Trainer, TrainerConfig
    total = FAULT_STEPS + ELASTIC_STEPS
    argv = [a if a != "top10" else "top10+natural" for a in SLICE_ARGS]
    argv[argv.index("--steps") + 1] = str(total)
    args = train_cli.parse_args(argv + ["--faults", FAULTS])
    _, tr0, data, sched = train_cli.setup(args, group=group)
    tr = Trainer(tr0.model, dataclasses.replace(tr0.tcfg, metrics=True),
                 device=tr0.device, group=group)
    budget = tr.wire_budget()
    faults = tr.tcfg.faults
    torch.cuda.synchronize()
    reset_all_launches()
    state, step = tr.init(args.seed), tr.make_step()
    rows = []
    for i in range(FAULT_STEPS):
        state, aux = step(state, data.batch_at(i), sched(i))
        m = aux["metrics"].host_floats()
        rows.append({"step": i, "loss": float(aux["loss"]),
                     "scheduled": int(faults.drop_mask(i).sum()),
                     "n_participants": int(aux["n_participants"]),
                     "demoted": m["part/demoted"],
                     "skipped": m["part/skipped_step"]})
    torch.cuda.synchronize()
    launches = all_launches()
    gathered = list(tr.gathered)
    want = expected_launches(tr, FAULT_STEPS * NS_STEPS * n_buckets,
                             packed=True, steps=FAULT_STEPS)
    tr2 = Trainer(tr0.model, dataclasses.replace(
        tr.tcfg, faults=None, participation="round_robin(1)"),
        device=tr0.device, group=group)
    step2 = tr2.make_step()
    for i in range(FAULT_STEPS, total):
        state, aux = step2(state, data.batch_at(i), sched(i))
        rows.append({"step": i, "loss": float(aux["loss"]),
                     "scheduled": 1,
                     "n_participants": int(aux["n_participants"]),
                     "demoted": aux["metrics"].host_floats()["part/demoted"],
                     "skipped": 0.0})
    torch.cuda.synchronize()
    del state, aux
    emit({"phase": "8.5 faults and elastic participation", "faults": FAULTS,
          "then": f"{ELASTIC_STEPS} steps of round_robin(1)", "rows": rows,
          "gathered_per_step": gathered[:len(budget.w2s_sizes)],
          "launches": launches})
    if not all(math.isfinite(r["loss"]) for r in rows):
        fail(f"fault run: non-finite losses {rows}")
    if any(r["n_participants"] != r["scheduled"] - r["demoted"]
           or r["skipped"] for r in rows) or rows[2]["demoted"] != 1 \
            or rows[4]["n_participants"] != 1:
        fail(f"fault run: participants not as scheduled: {rows}")
    if gathered != [2 * s for s in budget.w2s_sizes] * FAULT_STEPS:
        fail(f"fault run: gathers {gathered}, budget {budget.w2s_sizes}")
    if launches != want:
        fail(f"fault run: launches {launches}, the layouts imply {want}")
    del tr, tr2, tr0
    torch.cuda.empty_cache()
    scatter_and_codes_check(torch.device("cuda", 0))
    # reduced nanogpt, top10: the flipped index bytes take the masked
    # scatter on both devices
    rcfg = get_config("nanogpt-124m").reduced()
    spec = parse_faults(FAULTS, 2, seed=0)
    gloo = dist.new_group(backend="gloo")
    losses = {}
    for device, g in (("cuda", group), ("cpu", gloo)):
        rdata = SyntheticLM(rcfg, ShapeSpec("s", "train", 64, 4),
                            n_workers=2, seed=0, device=device)
        rtr = Trainer(build_model(rcfg), TrainerConfig(
            n_workers=2, beta=0.5, w2s="top10", faults=spec,
            participation=Explicit(EXPLICIT_MASKS)), device=device, group=g)
        losses[device] = train_cli.run_steps(
            rtr, rtr.init(0), rdata, sched, FAULT_STEPS)["losses"]
    gap = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    emit({"check": "reduced nanogpt with faults and an Explicit table, "
          "cuda vs cpu", "losses": losses, "max_abs_diff": gap,
          "tol": TOL_SLICE_LOSS})
    if not all(math.isfinite(v) for v in losses["cuda"]) \
            or not gap <= TOL_SLICE_LOSS:
        fail(f"reduced fault run on the card drifts from the CPU's: {gap}")
    return {"launches": launches, "rows": rows}


def obs_run(group, two_way: dict) -> dict:
    """8.6: the packed two-way run with metrics and trace spans through
    the sink: losses, bytes and launches equal the run without them, the
    JSONL valid, every metric finite; then one step under torch.profiler,
    its device ms per phase and wire stage span against the busy time."""
    import dataclasses
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.profile_step import (device_busy_ms,
                                                 span_device_ms)
    from repro_torch.obs.sink import MetricsWriter, run_manifest, \
        validate_jsonl
    from repro_torch.obs.trace import PHASE_SPANS
    from repro_torch.train.trainer import Trainer
    args = train_cli.parse_args(TWO_WAY_ARGS)
    cfg, tr0, data, sched = train_cli.setup(args, group=group)
    tr = Trainer(tr0.model, dataclasses.replace(
        tr0.tcfg, metrics=True, trace_spans=True), device=tr0.device,
        group=group)
    path = str(phase8_dir() / "metrics.jsonl")
    writer = MetricsWriter(path, manifest=run_manifest(
        tr.tcfg, None, extra={"arch": cfg.name}))
    torch.cuda.synchronize()
    reset_all_launches()
    out = train_cli.run_steps(tr, tr.init(args.seed), data, sched, STEPS,
                              log_every=1, writer=writer)
    torch.cuda.synchronize()
    launches = all_launches()
    gathered, broadcast = list(tr.gathered), list(tr.broadcast_bytes)
    writer.close()
    counts = validate_jsonl(path)
    with open(path) as f:
        steps = [json.loads(x) for x in f if '"kind": "step"' in x]
    finite = all(math.isfinite(v) for r in steps
                 for v in r["metrics"].values())
    train_cli._print_tables([], train_cli._ef_summary_rows(out["metrics"]))
    state, step = out.pop("state"), tr.make_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, aux = step(state, data.batch_at(STEPS), sched(STEPS - 1))
        float(aux["loss"])
        torch.cuda.synchronize()
    del state, aux, out["aux"]
    events = prof.events()
    spans, unlaunched = span_device_ms(events)
    busy = device_busy_ms(events)
    phases = sum(spans[n] for n in PHASE_SPANS)
    emit({"phase": "8.6 metrics, spans and the sink", "records": counts,
          "metrics_per_step": len(steps[-1]["metrics"]) if steps else 0,
          "losses": out["losses"], "plain_losses": two_way["losses"],
          "step_s": out["step_s"], "plain_step_s": two_way["step_s"],
          "launches": launches, "span_device_ms": spans,
          "device_busy_ms": busy, "phases_ms": phases,
          "device_ms_without_a_launch_record": unlaunched,
          "phases_share_of_busy": phases / busy})
    os.remove(path)
    if out["losses"] != two_way["losses"]:
        fail(f"metrics/spans changed the losses: {out['losses']} vs "
             f"{two_way['losses']}")
    if gathered != two_way["gathered"] \
            or broadcast != two_way["broadcast_bytes"] \
            or launches != two_way["launches"]:
        fail("metrics/spans changed the wire bytes or the launches")
    if counts.get("step") != STEPS or not finite:
        fail(f"metrics JSONL: {counts}, every metric finite: {finite}")
    if not abs(busy - phases) <= SPAN_TOL * busy:
        fail(f"phase spans hold {phases:.3f} of the step's {busy:.3f} "
             "device ms")
    torch.cuda.empty_cache()
    return {"spans": spans, "busy_ms": busy}


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

    # ---- 4a. end to end on a small input: card vs CPU plain versions,
    # one-way and two-way (the s2w leg's Natural encode, pack and decode)
    for w2s, s2w in SMALL_PATHS:
        small = SMALL_ARGS + ["--w2s", w2s, "--s2w", s2w]
        small_cuda = train_cli.main(small + ["--device", "cuda"])
        small_cpu = train_cli.main(small + ["--device", "cpu"])
        gap = max(abs(a - b) for a, b in zip(small_cuda["losses"],
                                             small_cpu["losses"]))
        emit({"check": f"reduced nanogpt losses, w2s {w2s}, s2w {s2w}, "
              "cuda vs cpu", "max_abs_diff": gap, "tol": TOL_SLICE_LOSS})
        if len(small_cuda["losses"]) != 3 or not gap <= TOL_SLICE_LOSS:
            fail(f"reduced nanogpt (w2s {w2s}, s2w {s2w}) on the card "
                 f"drifts from the CPU run: {gap}")

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
        torch.cuda.empty_cache()

        # ---- 6. the two-way step: EF21-P over the same group
        s2w_round_trip(group)
        torch.cuda.empty_cache()
        two_way = packed_run(train_cli.parse_args(TWO_WAY_ARGS), group,
                             iters)
        if two_way["gathered"] != natural["gathered"]:
            fail(f"two-way gathers {two_way['gathered']} differ from the "
                 f"one-way top10+natural run's {natural['gathered']}")
        torch.cuda.empty_cache()

        # ---- 7. the low-rank compressors: RankK one way, RankK+Natural
        # both ways; the s2w round trip, the sketches' NS and Natural
        # kernels on one step's real sketches and factors
        rank_one = packed_run(train_cli.parse_args(RANK_ARGS), group, iters)
        torch.cuda.empty_cache()
        rank_tr, rank_state = s2w_round_trip(group, RANK_TWO_WAY_ARGS,
                                             ("rank10+natural",))
        sketch_rows = rank_sketch_rows(rank_tr, rank_state)
        del rank_tr, rank_state
        torch.cuda.empty_cache()
        rank_two = packed_run(train_cli.parse_args(RANK_TWO_WAY_ARGS),
                              group, iters)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    # the same runs unpacked, through the CLI (no group)
    unpacked = {}
    for args, packed_out in ((TWO_WAY_ARGS, two_way), (RANK_ARGS, rank_one),
                             (RANK_TWO_WAY_ARGS, rank_two)):
        unpacked[tuple(args)] = unpacked_run(args, iters, packed_out)
    emit({"steady_step_s": {
        "one_way_packed": natural["step_s"][1:],
        "two_way_packed": two_way["step_s"][1:],
        "two_way_unpacked": unpacked[tuple(TWO_WAY_ARGS)]["step_s"][1:],
        "rank10_packed": rank_one["step_s"][1:],
        "rank10_unpacked": unpacked[tuple(RANK_ARGS)]["step_s"][1:],
        "rank10_two_way_packed": rank_two["step_s"][1:],
        "rank10_two_way_unpacked":
            unpacked[tuple(RANK_TWO_WAY_ARGS)]["step_s"][1:]},
        "peak_mem_bytes": {
            "one_way_packed": natural["peak"],
            "two_way_packed": two_way["peak"],
            "two_way_unpacked": unpacked[tuple(TWO_WAY_ARGS)]["peak"],
            "rank10_packed": rank_one["peak"],
            "rank10_unpacked": unpacked[tuple(RANK_ARGS)]["peak"],
            "rank10_two_way_packed": rank_two["peak"],
            "rank10_two_way_unpacked":
                unpacked[tuple(RANK_TWO_WAY_ARGS)]["peak"]}})
    torch.cuda.empty_cache()
    gluon = gluon_run(dev, cfg)

    # ---- 8. the run a user leaves alone: --donate, checkpoints and
    # resume, a crash, a stalled step under the supervisor, faults and
    # elastic participation on the packed wire, metrics and spans
    torch.cuda.empty_cache()
    donate_run(unpacked[tuple(TWO_WAY_ARGS)], iters)
    checkpoint_run(out)
    crash_run(out)
    stall_run(out)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        faulted = fault_run(dist.group.WORLD, n_buckets)
        obs_run(dist.group.WORLD, two_way)
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
    for r in ns_rows + wire_rows:
        r["two_way_launches"] = two_way["launches"][r["name"]]
        r["rank10_launches"] = rank_one["launches"][r["name"]]
        r["rank10_two_way_launches"] = rank_two["launches"][r["name"]]
    for r in ns_rows:
        r["gluon_launches"] = gluon["launches"][r["name"]]
    for r in ns_rows + wire_rows:
        r["fault_run_launches"] = faulted["launches"][r["name"]]
    # the NS chain at each sketch shape of the rank paths
    ns_rows[0]["sketch_chains"] = sketch_rows
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = ("design", "bound_ffma_ms", "effective_tflop_s",
             "executed_tflop_s", "flop_needed", "flop_executed",
             "fraction_of_bound", "tb_s", "in_step_ms", "copy_ms", "pad_ms",
             "chain_ms", "chain_eager_ms", "kept_outputs_ms",
             "body_launched_as", "body_launches", "two_way_launches",
             "rank10_launches", "rank10_two_way_launches", "gluon_launches",
             "fault_run_launches", "sketch_chains")
    emit({"kernels": [{k: r[k] for k in keys + extra if k in r}
                      for r in ns_rows + wire_rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
