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
     cast; and the f32 adds with XLA's NaN rule (``add_f32``, the
     estimates' E + delta, and ``fold_f32``, the server's fold) bit for
     bit on every leaf of a step, timed against their plain versions
     and the PyTorch calls they replace;
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
     8.7, the desynchronized-worker rejoin: 12 packed two-way steps with
     ``--resync 4`` and worker 1 dropped for rounds 1-2 (a replay at
     step 3) and 5-10 (a full W copy at step 11): the counts, the lag
     of every step, W_j bit-equal to W after the rejoins and at the end,
     the two-way run's gathers and broadcasts, launches as the layouts
     imply (the replay decodes every ring slot every step), peak and
     steps beside the prediction; resync with everyone present bit-equal
     to the two-way run; the same run unpacked through the CLI (its
     RESYNC_SUMMARY, losses and final state bit-equal, and
     ``serve_full_resync`` of its final checkpoint); a checkpoint after
     step 2 resumed, bit-equal; and the f32 adds of the replay, of
     ``apply_payload`` and of the server's fold on NaN payloads against
     the reference's bits;
  9. the worker axis over ranks: two processes on the one card over a
     gloo group (NCCL refuses two ranks on one device), one worker each,
     run the packed two-way steps and 8.7's drop run with ``--resync``:
     losses, x and W bit-equal to the one-rank runs', every step's
     gathers one worker's w2s stage bytes and its broadcasts the s2w
     stage buffers in issue order, each rank's two-way peak below the
     one-rank run's; then each stage buffer's host-staged gather and
     broadcast timed alone. The server's placement over the two ranks:
     every run splits each NS bucket 2 divides, and two more
     runs of the packed two-way step hold x, g_server and w cut by the
     zero-1 and the FSDP rules (``TrainerConfig(zero1_lmo=True)``,
     ``fsdp=True``): losses, x and W gathered whole bit-equal to the
     one-rank run, the wire's gathers and broadcasts the budget's, each
     rank's NS chains handed ``[B/2, m, n]`` of both buckets, the bytes
     of x, g_server and w each rank holds between steps exactly the
     specs', its peak at or below the plain two-rank run's, and each
     rank's phase-5 device ms beside the one-rank run's (a reading: the
     ranks share the card); reduced mixtral over the two ranks with
     ``zero1_lmo`` (its expert stacks through the split) bit-equal to a
     one-rank group; 9s, in the same two processes, the supervisor over
     them (``Supervisor(..., group=g, store=store, trainer=tr)``): rank
     1 raising at step 1 (every rank retries once, at once), rank 1
     wedged past the 6 s deadline in its first gather of step 2 (every
     rank retries on a new generation of groups while the orphan wakes;
     the wire's gathers and broadcasts the budget's; the seconds from the
     fault to the retry's end and the peak with the orphan alive),
     losses, x and W
     bit-equal to the two-way run; at 2 of 12 layers a reload (rank 0
     raising on every attempt of step 3: both rewind to step 2,
     bit-equal) and rank 1 exiting at step 1 (rank 0 names it within
     2 x 3 + 5 s of a 3 s deadline); then, in the parent, the NS chain on the
     whole, a half and a quarter of qwen's ``[24,2048,11008]`` and mixtral's
     ``[24,4096,14336]`` buckets, each part bit-equal to its slices of the
     whole, timed: a rank's LMO on 2 and 4 cards; 9c: nanogpt-124m at full
     width and 4 of 12 layers trained over a ``(data=2, model=2)`` mesh of four
     ranks on the one card over gloo (``Trainer(..., mesh=...)``: each
     data row's two ranks run one worker with the weights cut on
     ``model``), packed ``top10+natural`` / ``natural``, 3 steps of 2 x
     1024 a worker, against one process's run of the same config, seed
     and batches: step 0's loss, finite losses, each rank's bytes at
     rest of x, w, g_server, g_w and m_w the specs', the wire's gathers
     the budget's, the NS and wire kernels launched, the collectives by
     tag, the MetricSet on (step 0's within 1e-5 of one process's fed
     the ranks' gradients and within 1e-3 of its own run; the state
     bit-equal to a metrics-off step's); then each NS bucket's chain at
     a rank's chunk shape (the columns cut, the gram partials summed
     over the model pair; the rows cut) against its plain version and
     the whole chain; 9d: the same run over ``(pod=2, data=2,
     model=1)``, a worker a pod and a row a rank, with 9c's checks but
     the fed MetricSet and the metrics-off step, the wire over the pod
     subgroups, and the NS chains at a rank's ``(pod, data)`` rows;
 10. the dense family beside nanogpt: the four reduced dense archs
     (qwen2.5-3b, granite-3-2b, starcoder2-15b, mistral-large-123b:
     RMSNorm, RoPE, SwiGLU, GQA, QKV bias, a sliding window, an untied
     unembedding), 3 two-way steps each, card vs CPU; the NS kernels at
     qwen2.5-3b's three bucket shapes against their plain versions (the
     largest also against float64), timed against cuBLAS f32 and the
     bound; qwen2.5-3b at full width cut to 8 layers, 4 steps each:
     unpacked top10 through ``setup``/``run_steps``, then over a one-rank
     NCCL group step 0's payloads through the wire, packed top10 (losses
     against the unpacked run, gathers against the budget, launches as
     the layouts imply), the wire kernels at its row shapes bit for bit
     against their plain versions, the server's natural message after
     one two-way step through the s2w wire, and packed two-way
     ``top10+natural``/``natural``; then one loss-and-gradient pass of
     all 36 layers (3.09 B parameters): time, peak, finite gradients;
 11. serving and the Mixtral MoE: qwen2.5-3b at full width (18 of 36 layers,
     batch 8, prompt 2048, 128 new tokens) and starcoder2-15b (20 of its 40
     layers, batch 2, a prompt of 4608 over its 4096-token window: the ring
     cache of capacity 4096) through ``Server.generate``, greedy, twice (the
     same tokens): prefill s, decode ms a token against its bytes bound, the
     peak, the host's share of a profiled decode step, none of the port's
     kernels launched; decode against the full forward on 3 teacher-forced
     positions within the reference test's 0.05 in f32 on the same weights (in
     bf16, as served, reported); mixtral-8x7b at full width served at 4 layers
     (that check at a no-drop capacity) and trained at 1 layer: the NS kernels
     at its buckets (``[24,4096,14336]`` the widest) against the plain version,
     float64 and cuBLAS f32, 3 steps unpacked top10, packed top10 over a
     one-rank NCCL group (losses bit-equal, gathers, launches), and packed
     two-way top10+natural / natural where its predicted peak fits; the reduced
     granite, starcoder2 (window 6) and mixtral served card against CPU (and
     deepseek's, phase 12), and reduced mixtral's 3 two-way steps;
 12. deepseek-v3-671b (MLA with the absorbed latent cache, top-8 sigmoid
     routing with a shared expert, the MTP head): reduced and a reduced
     top-8 variant, 3 two-way steps card vs CPU, and served card vs CPU
     (in 11's check); the MoE's fixed-order combine and the dispatch
     gather's gradient at full-width routing (4,096 tokens, 256 experts,
     top-8) bit for bit against the CPU's; served at full width with 1
     dense and 2 MoE layers (26.1 B parameters drawn on the card, batch
     4, prompt 1024, 32 new tokens) through ``serve_full``, greedy
     twice; decode against the full forward on the training cut in f32
     (bf16 reported); the cut (every per-layer width, 1 dense and 1 MoE
     layer, 16 routed experts, vocab 32,768) trained for 3 donated steps,
     its NS buckets asserted, unpacked and packed top10 bit-equal; the NS
     kernels at its buckets against the plain version, float64 and
     cuBLAS f32;
 13. qwen2-vl-7b (M-RoPE over a prompt of patch embeddings) and
     whisper-small (an encoder over 1500 frames, cross-attention, the
     cross K/V cache): reduced, 3 two-way steps card vs CPU; qwen2-vl
     served whole (28 layers, 7.6 B parameters drawn on the card, batch
     8, 2048 patch embeddings + 64 new tokens) and whisper (batch 8, 1500
     frames, 4 + 64 tokens) through ``serve_full``, greedy twice; decode
     after each prompt against the full forward in f32 (bf16 reported);
     qwen2-vl's training cut (every width, 2 layers, 2 workers, 4 x 1024,
     3 donated steps, losses bit-equal unpacked and packed top10) and
     whisper whole (2 workers, 8 x 448, top10 / natural, losses
     bit-equal unpacked and packed); the NS kernels at their buckets;
 14. recurrentgemma-2b (the RG-LRU as a log-depth scan, the causal
     conv, local MQA attention over a ring of its 2048 window, the
     pattern's remainder stack) and xlstm-1.3b (the chunkwise mLSTM, the
     serial sLSTM): reduced, 3 two-way steps (beside the CPU on float64
     gradients) and serving card vs CPU; served (griffin whole, 26
     layers, 2.89 B parameters, batch 8, a prompt of 4096, twice its
     window, + 64; xlstm at 1 of its 6 periods, 8 x (2048 + 64)) through
     ``serve_full``, greedy twice; decode after each prompt against the
     full forward, griffin's in f32, xlstm's in float64 (its f32 gap
     grows with depth; f32 and bf16 reported); xlstm's sLSTM loop's
     launches a token; the training cuts (griffin 2 periods, 1.17 B
     parameters, its peak predicted first; xlstm 1 period, 0.77 B), 2
     workers, 4 x 1024, 3 donated steps, their NS buckets asserted from
     the plan, losses bit-equal unpacked and packed top10; the NS kernels
     at their buckets;
 15. prints one JSON line of per-kernel numbers, then, as the last line,
     {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any

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

# exact u8 bytes of each wire the smoke packs, 2 workers, by (arch,
# layers): "w2s" a worker's stage buffers under each compressor (an int
# where only the total is pinned), "s2w" the server's message (one
# message, lead 1) by stage, "order" the order its stage broadcasts are
# issued in. The CPU tests pin the same (tests/test_torch_wire.py,
# tests/test_torch_s2w.py, tests/test_torch_rank.py,
# tests/test_torch_dense_zoo.py).
WIRE = {
    ("nanogpt-124m", 12): {
        "w2s": {"top10": 66_194_428, "top10+natural": 55_313_394,
                "rank10": (8_294_656, 14_192_640, 11_354_112),
                "rank10+natural": (4_732_944, 7_983_360, 6_386_688)},
        "s2w": {"natural": (44_500_992, 63_700_992, 31_850_496),
                "top10": (23_726_908, 28_311_600, 14_155_920),
                "rank10+natural": (4_732_944, 7_983_360, 6_386_688)},
        "order": (1, 0, 2)},
    ("qwen2.5-3b", 8): {
        "w2s": {"top10": (186_920_142, 324_639_216, 33_554_480, 4_194_320),
                "top10+natural": (159_693_211, 277_296_000, 27_682_448,
                                  3_460_320)},
        "s2w": {"natural": (350_281_728, 608_698_368, 75_497_472,
                            9_437_184)},
        "order": (1, 0, 2, 3)},
    ("mixtral-8x7b", 1): {
        "w2s": {"top10": (157_335_552, 845_571_744, 16_777_220, 4_194_310,
                          13_108),
                "top10+natural": (134_397_952, 722_259_216, 13_841_208,
                                  3_460_306, 10_241)},
        "s2w": {"natural": (294_961_152, 1_585_446_912, 37_748_736,
                            9_437_184, 36_864)},
        "order": (1, 0, 2, 3, 4)}}
NANOGPT_WIRE = WIRE["nanogpt-124m", 12]
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
# the f32 adds of the resync replay (W_j + delta, as apply_payload) and
# of the server's fold (g_server + sum_j d_j / count) on NaN payloads:
# quiet and signalling, both signs, in one operand or both. *_WANT are the
# reference's bits (XLA on the CPU; tests/test_torch_resync.py computes
# them with JAX), which phase 8.7 holds the card's adds against
NAN_ADD_W = (0x7FC00001, 0xFFA00000, 0x3F800000, 0x7F800001, 0x40000000,
             0xFFC00123, 0x7FC00002, 0x00000000)
NAN_ADD_DELTA = (0x3F800000, 0x3F800000, 0x7FC00456, 0x7FC00789,
                 0xFFFFFFFF, 0x7FA00001, 0xFF800000, 0xFFC00321)
NAN_ADD_WANT = (0x7FC00001, 0xFFE00000, 0x7FC00456, 0x7FC00001, 0xFFFFFFFF,
                0xFFC00123, 0x7FC00002, 0xFFC00321)
NAN_FOLD_G = (0x3F800000, 0x7FC00ABC, 0x40000000, 0xFFC00001)
NAN_FOLD_D = (0x7FC00011, 0x3F800000, 0x7FC00022, 0x3F800000,    # worker 0
              0x7FC00033, 0x40000000, 0x40400000, 0xFF800001)    # worker 1
NAN_FOLD_COUNT = 2.0
NAN_FOLD_WANT = (0x7FC00011, 0x7FC00ABC, 0x7FC00022, 0xFFC00001)

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


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line (one with a "phase" or "check" key)
    gets ``t_s``, the seconds since the smoke started."""
    if "phase" in obj or "check" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
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
    return rows + [cast_row(dev, gen, plan_top10)] \
        + f32_add_rows(dev, gen, plan_top10)


def f32_add_rows(dev, gen, plan) -> list[dict]:
    """The f32 adds with XLA's NaN rule over one step's calls (2 workers,
    every leaf of ``plan``): ``add_f32`` as the workers' EF21 round
    (``[2, *shape]`` estimate + delta) and ``fold_f32`` as the server's
    fold (``g + mean_j d_j``), each bit for bit against its plain version
    with NaNs of both signs, +-inf, +-0 among the values, the replay's
    one delta for both workers' W_j, the elastic arm's device count and
    in place; then timed as CUDA-graph replays of the step's calls
    against the plain versions and the PyTorch calls they replace
    (``add_``; ``torch.mean`` and ``add_``)."""
    import numpy as np
    import torch
    from repro_torch.kernels import natural_pack as nat
    from repro_torch.kernels import ref
    special = torch.from_numpy(np.array(
        NAN_BITS + (0x7F800000, 0xFF800000, 0, 0x80000000, 0x3F800000),
        np.uint32).view(np.float32)).to(dev)

    def leaf(shape, flip=False):
        t = torch.randn(shape, device=dev, generator=gen)
        sp = special.flip(0) if flip else special
        t.view(-1)[:sp.numel()] = sp
        return t

    def bits(t):
        return t.view(torch.int32)

    est = [leaf((2,) + lp.shape) for lp in plan.leaves]
    delta = [leaf((2,) + lp.shape, flip=True) for lp in plan.leaves]
    g = [leaf(lp.shape) for lp in plan.leaves]
    count = torch.tensor(2.0, device=dev)
    for i, lp in enumerate(plan.leaves):
        tag = f"{list(lp.shape)}"
        check_equal(f"add_f32 {tag}", bits(nat.add_f32(est[i], delta[i])),
                    bits(ref.add_f32_ref(est[i], delta[i])))
        check_equal(f"fold_f32 {tag}", bits(nat.fold_f32(g[i], delta[i], 2)),
                    bits(ref.fold_f32_ref(g[i], delta[i], 2)))
    big = max(range(len(g)), key=lambda i: g[i].numel())
    check_equal("add_f32 one delta for both workers' W_j",
                bits(nat.add_f32(delta[big][0], est[big])),
                bits(ref.add_f32_ref(delta[big][0], est[big])))
    check_equal("fold_f32 by the elastic arm's device count",
                bits(nat.fold_f32(g[big], delta[big], count)),
                bits(ref.fold_f32_ref(g[big], delta[big], count)))
    want = ref.add_f32_ref(est[big], delta[big])
    a = est[big].clone()
    nat.add_f32(a, delta[big], out=a)
    check_equal("add_f32 in place (out is a)", bits(a), bits(want))
    want = ref.fold_f32_ref(g[big], delta[big], 2)
    a = g[big].clone()
    nat.fold_f32(a, delta[big], 2, out=a)
    check_equal("fold_f32 in place (out is g)", bits(a), bits(want))
    odd = est[big].view(-1)[1:1003]
    check_equal("add_f32 not 16-byte aligned",
                bits(nat.add_f32(odd, delta[big].view(-1)[:1002])),
                bits(ref.add_f32_ref(odd, delta[big].view(-1)[:1002])))
    del a, want, odd
    n = sum(t.numel() for t in g)
    outs = [torch.empty_like(t) for t in est]
    gouts = [torch.empty_like(t) for t in g]
    b_add, by_add = bound_ms(2 * 2 * n, 12 * 2 * n, rate=INT32_OPS_S)
    b_fold, by_fold = bound_ms(6 * 2 * n, 4 * (2 + 2) * n, rate=INT32_OPS_S)
    add_row = {
        "name": "add_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/natural_pack.cu",
        "replaces": REPLACES["add_f32"], "max_abs_err": 0.0,
        "ms": graph_ms([lambda i=i: nat.add_f32(est[i], delta[i],
                                                out=outs[i])
                        for i in range(len(est))], passes=4),
        "plain_ms": graph_ms([lambda i=i: ref.add_f32_ref(est[i], delta[i])
                              for i in range(len(est))], passes=2),
        "library_ms": graph_ms([lambda i=i: torch.add(est[i], delta[i],
                                                      out=outs[i])
                                for i in range(len(est))], passes=4),
        "bound_ms": b_add, "bound_by": by_add}
    fold_row = {
        "name": "fold_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/natural_pack.cu",
        "replaces": REPLACES["fold_f32"], "max_abs_err": 0.0,
        "ms": graph_ms([lambda i=i: nat.fold_f32(g[i], delta[i], 2,
                                                 out=gouts[i])
                        for i in range(len(g))], passes=4),
        "plain_ms": graph_ms([lambda i=i: ref.fold_f32_ref(g[i], delta[i], 2)
                              for i in range(len(g))], passes=2),
        "library_ms": graph_ms([lambda i=i: gouts[i].copy_(g[i]).add_(
            torch.mean(delta[i], dim=0)) for i in range(len(g))], passes=4),
        "bound_ms": b_fold, "bound_by": by_fold}
    for r, elems in ((add_row, 2 * n), (fold_row, n)):
        r["fraction_of_bound"] = r["bound_ms"] / r["ms"]
        r["tb_s"] = (12 if r is add_row else 16) * elems / r["ms"] / 1e9
    emit({"f32_add_times": "one step's EF21 estimate adds and folds, "
          "2 workers", "elements_per_worker": n, "calls": len(g),
          "add_f32_ms": add_row["ms"], "add_plain_ms": add_row["plain_ms"],
          "torch_add_ms": add_row["library_ms"],
          "fold_f32_ms": fold_row["ms"],
          "fold_plain_ms": fold_row["plain_ms"],
          "torch_mean_add_ms": fold_row["library_ms"],
          "add_bound_ms": b_add, "fold_bound_ms": b_fold})
    del est, delta, g, outs, gouts
    torch.cuda.empty_cache()
    return [add_row, fold_row]


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
            "to_bf16": "src/repro/core/error_feedback.py:38",
            # not TPU kernels: XLA's adds, the estimate's E + delta and
            # the server's fold g + mean_j d_j
            "add_f32": "src/repro/core/error_feedback.py:47",
            "fold_f32": "src/repro/core/muon.py:718"}


def reset_all_launches() -> None:
    from repro_torch.kernels import bitpack, natural_pack, newton_schulz
    for mod in (bitpack, natural_pack, newton_schulz):
        mod.reset_launches()


def all_launches() -> dict:
    from repro_torch.kernels import bitpack, natural_pack, newton_schulz
    return {**newton_schulz.LAUNCHES, **bitpack.LAUNCHES,
            **natural_pack.LAUNCHES}


def wire_round_trip(args, group, cfg=None) -> None:
    """Step 0's full-width payloads (2 workers, from the initial state
    on the first batch, as phase 3 makes them) through each stage's
    pack -> all-gather -> unpack: every payload leaf comes back bit for
    bit. ``cfg`` replaces the config ``args`` name (``setup``'s)."""
    import torch
    from repro_torch.core.error_feedback import ef_compress_step
    from repro_torch.launch import train as train_cli
    from repro_torch.wire.codecs import flatten_payload
    _, tr, data, _ = train_cli.setup(args, group=group, cfg=cfg)
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
    casts W to the params' dtype for the gradients, once per leaf; with
    resync (ring depth R) once per leaf and worker (each worker at its
    own W_j), and the replay decodes every ring slot every step, R
    decodes per s2w leaf (Natural codes, TopK indices), as the
    reference does; unpacked, the ring's row is packed locally (the s2w
    TopK indices narrow-encoded). Every leaf folds once a step
    (``fold_f32``), and every estimate's add is one ``add_f32`` a leaf:
    the workers' EF21 round, the s2w leg's W and each replayed ring slot.
    ``n_ns_iters`` counts the LMO's NS iterations."""
    import torch
    from repro_torch.core.compressors import RankK
    from repro_torch.dist.layerwise import tree_leaves
    from repro_torch.dist.resync import resolve_ring_depth
    plan = tr.layer_plan()
    ring = resolve_ring_depth(tr.opt.cfg.resync)
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
    if ring:
        n_cast *= tr.opt.cfg.n_workers
    n_ns = n_ns_iters + steps * NS_STEPS * n_rank
    return {"ns_iteration": 2 * n_ns, "fused_matmul": n_ns,
            "to_bf16": steps * (n_lossy + 2 * n_rank + n_cast),
            "narrow_encode": steps * (n_narrow + (len(narrow_s) if ring
                                                  and not packed else 0)),
            "narrow_decode": steps * (n_narrow + ring * len(narrow_s)),
            "natural_encode": steps * (len(natural) + len(natural_s)),
            "pack_bits": steps * (len(natural) + len(natural_s)),
            "natural_decode": steps * (2 * len(natural)
                                       + (1 + ring) * len(natural_s)),
            "unpack_bits": 0,
            "add_f32": steps * len(plan.leaves) * (1 + two_way + ring),
            "fold_f32": steps * len(plan.leaves)}


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


def first_loss_band(cfg) -> tuple[float, float]:
    """(centre, half-width) of a fresh model's first loss: ln(vocab), the
    logits' variance adding ~0.5, within 1; with an MTP head, whose
    cross-entropy adds at weight MTP_WEIGHT, (1 + MTP_WEIGHT) times
    both."""
    scale = 1.0 + MTP_WEIGHT if cfg.mtp else 1.0
    return scale * math.log(cfg.vocab), scale


def packed_run(args, group, n_ns_iters: int, keep_state: bool = False,
               cfg=None, steps: int = STEPS) -> dict:
    """``steps`` full-width steps through a Trainer over ``group``:
    checks the losses, the gathers (and, with a compressing ``--s2w``, the
    broadcasts) against the wire budget and every kernel's launches
    against what the layouts imply. ``keep_state``: the result holds the
    last state's x and w, copied to the host. ``cfg`` replaces the config
    ``args`` name; its wire is held to ``WIRE``'s numbers."""
    import torch
    from repro_torch.launch import train as train_cli
    cfg, tr, data, sched = train_cli.setup(args, group=group, cfg=cfg)
    pins = WIRE[cfg.name, cfg.n_layers]
    w2s = pins["w2s"][args.w2s]
    budget = tr.wire_budget()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    out = train_cli.run_steps(tr, tr.init(args.seed), data, sched, steps)
    torch.cuda.synchronize()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    tag = f"{args.w2s} / s2w {args.s2w}"
    emit({"packed": args.w2s, "s2w": args.s2w, "steps": steps,
          "losses": losses, "step_s": out["step_s"], "peak_mem_bytes": peak,
          "gathers_per_step": len(tr.gathered) / steps,
          "gathered_bytes_per_step": sum(tr.gathered) / steps,
          "broadcasts_per_step": len(tr.broadcast_bytes) / steps,
          "broadcast_bytes_per_step": sum(tr.broadcast_bytes) / steps,
          "w2s_sizes": budget.w2s_sizes, "s2w_sizes": budget.s2w_sizes,
          "launches": launches})
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        fail(f"{tag} packed run: non-finite or missing losses {losses}")
    centre, half = first_loss_band(cfg)
    if abs(losses[0] - centre) > half:
        fail(f"{tag} packed run: initial loss {losses[0]} more than {half} "
             f"from {centre:.3f}")
    if budget.w2s_nbytes != (w2s if isinstance(w2s, int) else sum(w2s)) \
            or budget.n_stages != len(pins["order"]) \
            or not isinstance(w2s, int) and budget.w2s_sizes != w2s:
        fail(f"{tag} wire budget {budget}")
    n_w = args.workers
    if tr.gathered != [n_w * s for s in budget.w2s_sizes] * steps:
        fail(f"{tag} gathers {tr.gathered}, expected "
             f"{[n_w * s for s in budget.w2s_sizes]} per step")
    want_bc = ([pins["s2w"][args.s2w][k] for k in pins["order"]]
               if args.s2w != "identity" else [])
    if budget.s2w_sizes != pins["s2w"].get(args.s2w, ()) \
            or tr.broadcast_bytes != want_bc * steps:
        fail(f"{tag} broadcasts {tr.broadcast_bytes} (budget "
             f"{budget.s2w_sizes}), expected {want_bc} per step")
    want = expected_launches(tr, n_ns_iters, packed=True, steps=steps)
    if launches != want:
        fail(f"{tag} launches {launches}, the layouts imply {want}")
    kept = ({k: to_host(out["state"][k]) for k in ("x", "w")}
            if keep_state else {})
    return {"losses": losses, "step_s": out["step_s"], "peak": peak,
            "launches": launches, "gathered": tr.gathered,
            "broadcast_bytes": tr.broadcast_bytes, **kept}


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
                   names=("natural", "top10"), cfg=None) -> tuple:
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
    RankK's next sketch is X^T P = 0 whatever X - W). Each message goes
    through the broadcast hook of a trainer with its s2w compressor,
    whose runtime check holds it to that compressor's budget, and its
    stage buffers and issue order to ``WIRE``'s. ``cfg`` replaces the
    config ``args`` name. Returns the trainer and the state after the
    step."""
    import dataclasses
    import torch
    from repro_torch.core.error_feedback import apply_payload, ef_compress_step
    from repro_torch.dist.layerwise import LayerPlan
    from repro_torch.dist.pipeline import s2w_issue_order
    from repro_torch.kernels import bitpack as bp
    from repro_torch.launch import train as train_cli
    from repro_torch.train.trainer import Trainer
    from repro_torch.wire.codecs import flatten_payload, unflatten_payload
    arch, tr, data, sched = train_cli.setup(train_cli.parse_args(args),
                                            group=group, cfg=cfg)
    state, _ = tr.make_step()(tr.init(0), data.batch_at(0), sched(1))
    pins = WIRE[arch.name, arch.n_layers]
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
        hook = tr if s2w == cfg.s2w else Trainer(
            tr.model, dataclasses.replace(tr.tcfg, s2w=s2w),
            device=tr.device, group=group)
        hook.broadcast_bytes.clear()
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
                             sw.unpack_stage(k, hook._broadcast(buf))):
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
        sizes, want_order = pins["s2w"][s2w], pins["order"]
        if hook.broadcast_bytes != [sizes[k] for k in want_order] \
                or tuple(order) != want_order:
            fail(f"s2w {s2w} round trip: broadcasts {hook.broadcast_bytes} in "
                 f"order {order}, expected {want_order} of {sizes}")
        torch.cuda.synchronize()
        emit({"check": f"the server's {s2w} message after one step through "
              "the s2w wire", "stages": sw.n_stages, "leaves": n_leaves,
              "issue_order": order, "bytes_broadcast": hook.broadcast_bytes,
              "lossy_leaves_vs_plain": len(rows), "longest_row": max(rows),
              "bit_equal": True})
        del sent, w_want, lead, hook
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


# 8.2 runs nanogpt at full width and this depth (of 12): its archives'
# round trips, the resume and the torn-write fallback do not need every
# layer, and its saves and loads of the full-depth state took ~45 s of
# the smoke (the CLI's --resume runs in 8.3)
CKPT_DEPTH = 2


def checkpoint_run() -> dict:
    """8.2, nanogpt at CKPT_DEPTH layers: top10 steps 0-1, a checkpoint
    after each, then a resume for steps 2-3 (losses vs the uninterrupted
    4 steps, TOL_PACKED_LOSS); the newest generation loads bit for bit,
    and truncated it falls back to .prev with a warning; then a two-way
    rank10+natural state after one step round-trips bit for bit."""
    import os
    import warnings
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.train.checkpoint import (load_checkpoint,
                                              save_checkpoint,
                                              state_template)
    t_stage = time.perf_counter()
    cfg = get_config("nanogpt-124m").with_depth(CKPT_DEPTH)
    path = str(phase8_dir() / "top10")
    args = train_cli.parse_args(SLICE_ARGS)
    _, tr, data, sched = train_cli.setup(args, cfg=cfg)
    base = train_cli.run_steps(tr, tr.init(args.seed), data, sched, STEPS)
    del base["state"], base["aux"]
    s1 = train_cli.run_steps(tr, tr.init(args.seed), data, sched,
                             1)["state"]
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
    del s2
    torch.cuda.empty_cache()
    resumed = train_cli.run_steps(tr, got, data, sched, STEPS, start=step)
    del got, resumed["state"], resumed["aux"]
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
    del prev, s1, tr
    torch.cuda.empty_cache()
    rpath = str(phase8_dir() / "rank10_two_way")
    rargs = train_cli.parse_args(RANK_TWO_WAY_ARGS)
    _, rtr, rdata, rsched = train_cli.setup(rargs, cfg=cfg)
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
    emit({"phase": "8.2 checkpoint", "n_layers": CKPT_DEPTH,
          "file_bytes": nbytes, "save_s": save_s, "load_s": load_s,
          "resumed_losses": resumed["losses"],
          "uninterrupted_losses": base["losses"][2:],
          "max_abs_diff": gap, "tol": TOL_PACKED_LOSS,
          "torn_newest_fell_back_to_prev": True,
          "rank10_two_way_file_bytes": rbytes, "rank10_sketch_states": n_q,
          "rank10_two_way_bit_equal": True,
          "wall_s": time.perf_counter() - t_stage})
    if len(resumed["losses"]) != 2 or not gap <= TOL_PACKED_LOSS:
        fail(f"checkpoint: resumed losses drift from the uninterrupted "
             f"run's: {gap}")
    return {"file_bytes": nbytes, "save_s": save_s, "load_s": load_s}


# 8.3 runs the CLI on reduced nanogpt (2 layers, d 256): the crash, its
# exit code and the resume do not need the full model, whose checkpoints
# took most of the stage's ~63 s (8.2 saves and loads at full width)
CRASH_ARGS = SLICE_ARGS + ["--reduced"]


def crash_run() -> None:
    """8.3: the CLI under the supervisor with a periodic checkpoint and a
    crash fault, in a subprocess: it exits with CRASH_EXIT; the --resume
    run finishes with the uninterrupted run's final loss (CRASH_ARGS)."""
    import os
    from repro_torch.launch import train as train_cli
    from repro_torch.train.faults import CRASH_EXIT
    base = train_cli.main(CRASH_ARGS)
    path = str(phase8_dir() / "crash")
    extra = ["--supervise", "--checkpoint", path, "--checkpoint-every",
             "2", "--faults", "crash:step=2"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *CRASH_ARGS, *extra], env=env, cwd=str(ROOT),
                       capture_output=True, text=True, timeout=600)
    crash_s = time.perf_counter() - t0
    if r.returncode != CRASH_EXIT:
        fail(f"crash run exited {r.returncode}, not {CRASH_EXIT}: "
             f"{r.stderr[-2000:]}")
    resumed = train_cli.main(CRASH_ARGS + extra + ["--resume", path])
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


# ------------------------------------------------------------ phase 8.7
# the desynchronized-worker rejoin: worker 1 misses rounds 1-2 (a replay
# at step 3, 2 rounds behind, R = 4) and rounds 5-10 (a full W copy at
# step 11, 6 rounds behind)
RESYNC_R, RESYNC_STEPS = 4, 12
RESYNC_FAULTS = "drop:w=1:steps=1-3,drop:w=1:steps=5-11"
RESYNC_LAGS = [0, 1, 2, 0, 0, 1, 2, 3, 4, 5, 6, 0]
RESYNC_REJOINS = (3, 11)
RESYNC_RESUME_AT = 3     # the checkpoint after steps 0-2: 2 rounds behind
RESYNC_ARGS = list(TWO_WAY_ARGS) + ["--resync", str(RESYNC_R),
                                    "--faults", RESYNC_FAULTS]
RESYNC_ARGS[RESYNC_ARGS.index("--steps") + 1] = str(RESYNC_STEPS)
# run (a)'s peak as PERF.md §6 (PR 21) predicts it before any run: the
# packed two-way peak, 18,582,422,016 B, plus W_j (2 x 497,571,840 B) and
# the ring (4 x 140,052,480 B), each twice (the undonated step's input
# and output are both alive through the backward)
PEAK_RESYNC_PREDICTED = 18_582_422_016 + 2 * (2 * 497_571_840
                                              + 4 * 140_052_480)


def to_host(tree):
    """A copy of a state (tree of tensors, lists, scalars) on the host."""
    import torch
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_host(v) for v in tree]
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def nan_add_check(dev) -> dict:
    """The f32 adds of the replay (W_j + delta), of ``apply_payload``
    (not in place and in place) and of the server's fold on NaN payloads,
    on the card through ``add_f32`` and ``fold_f32`` (the mean's and the
    elastic arm's count), against the reference's bits (NAN_*_WANT): a
    difference fails the run."""
    import numpy as np
    import torch
    from repro_torch.core.compressors import Identity
    from repro_torch.core.error_feedback import apply_payload
    from repro_torch.kernels.natural_pack import add_f32, fold_f32

    def f32(bits):
        return torch.from_numpy(np.asarray(bits, np.uint32).view(
            np.int32)).to(dev).view(torch.float32)

    def bits(t):
        return tuple(int(v) for v in
                     t.view(torch.int32).cpu().numpy().view(np.uint32))

    w, delta = f32(NAN_ADD_W), f32(NAN_ADD_DELTA)
    d = f32(NAN_FOLD_D).reshape(2, -1)
    g = f32(NAN_FOLD_G)
    count = torch.tensor(NAN_FOLD_COUNT, dtype=torch.float32, device=dev)
    got = {"add": bits(add_f32(w, delta)),
           "add_inplace": bits(_inplace_add(w, delta)),
           "apply_payload": bits(apply_payload(Identity(), delta, w)),
           "apply_payload_inplace": bits(apply_payload(
               Identity(), delta, w.clone(), inplace=True)),
           "fold": bits(fold_f32(g, d, count)),
           "fold_mean": bits(fold_f32(g, d, int(NAN_FOLD_COUNT)))}
    want = {k: NAN_FOLD_WANT if k.startswith("fold") else NAN_ADD_WANT
            for k in got}
    out = {k: {"card": [f"0x{v:08X}" for v in got[k]],
               "reference": [f"0x{v:08X}" for v in want[k]],
               "equal": got[k] == want[k]} for k in got}
    emit({"check": "f32 adds on NaN payloads against the reference's bits",
          "adds": out})
    bad = [k for k in got if got[k] != want[k]]
    if bad:
        fail(f"the card's f32 adds {bad} on NaN payloads differ from the "
             f"reference's bits: {out}")
    return out


def _inplace_add(w, delta):
    from repro_torch.kernels.natural_pack import add_f32
    a = w.clone()
    add_f32(a, delta, out=a)
    return a


def all_current(state) -> bool:
    """Every worker's W_j bit-equal to the server's W."""
    import torch
    from repro_torch.dist.layerwise import tree_leaves
    return all(torch.equal(ww[j].view(torch.int32), w.view(torch.int32))
               for w, ww in zip(tree_leaves(state["w"]),
                                tree_leaves(state["w_w"]))
               for j in range(ww.shape[0]))


def replay_profile(group) -> dict:
    """Step 1 of (b)'s run with trace spans under ``torch.profiler``: the
    device ms of each phase and of the resync replay (ring push in p1,
    the slot decodes, the masked adds and the full copy in
    ``resync/replay``), against the step's busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.profile_step import (device_busy_ms,
                                                 span_device_ms)
    from repro_torch.obs.trace import PHASE_SPANS, RESYNC_SPAN
    args = train_cli.parse_args(TWO_WAY_ARGS + ["--resync", str(RESYNC_R),
                                                "--trace-spans"])
    _, tr, data, sched = train_cli.setup(args, group=group)
    step = tr.make_step()
    state, _ = step(tr.init(args.seed), data.batch_at(0), sched(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, aux = step(state, data.batch_at(1), sched(1))
        float(aux["loss"])
        torch.cuda.synchronize()
    del state, aux
    torch.cuda.empty_cache()
    events = prof.events()
    spans, _ = span_device_ms(events)
    return {"device_busy_ms": device_busy_ms(events),
            "span_device_ms": {n: spans.get(n, 0.0)
                               for n in PHASE_SPANS + (RESYNC_SPAN,)}}


def resync_run(group, two_way: dict, n_buckets: int) -> dict:
    """8.7: the rejoin at full width. (a) RESYNC_ARGS packed over
    ``group``: replays and full copies, the lags, W_j bit-equal to W
    after the rejoins, gathers and broadcasts as the two-way run's,
    launches as the layouts imply; (b) resync on with everyone present,
    bit-equal to the two-way run; (c) (a) unpacked through the CLI, the
    same summary, losses and final W_j, W and x; (d) (a) checkpointed
    after RESYNC_RESUME_AT steps and resumed, bit-equal to (a), and
    serve_full_resync of the final checkpoint."""
    import os
    import torch
    from repro_torch.dist.resync import serve_full_resync
    from repro_torch.launch import train as train_cli
    from repro_torch.train.checkpoint import (load_checkpoint,
                                              save_checkpoint,
                                              state_template)
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    nan = nan_add_check(dev)
    per_step = NS_STEPS * n_buckets
    # (a)
    args = train_cli.parse_args(RESYNC_ARGS)
    _, tr, data, sched = train_cli.setup(args, group=group)
    budget = tr.wire_budget()
    want = expected_launches(tr, RESYNC_STEPS * per_step, packed=True,
                             steps=RESYNC_STEPS)
    step = tr.make_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    state = tr.init(args.seed)
    losses, step_s, lags, counts, current = [], [], [], [0, 0], {}
    for i in range(RESYNC_STEPS):
        t0 = time.perf_counter()
        state, aux = step(state, data.batch_at(i), sched(i))
        losses.append(float(aux["loss"]))
        step_s.append(time.perf_counter() - t0)
        lags.append(int(aux["version_lag_max"]))
        counts[0] += int(aux["resync_replayed"])
        counts[1] += int(aux["resync_full"])
        if i in RESYNC_REJOINS:
            current[f"after step {i}"] = all_current(state)
    torch.cuda.synchronize()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    current["at the end"] = all_current(state)
    gathered, broadcast = list(tr.gathered), list(tr.broadcast_bytes)
    final = to_host(state)
    del state, aux
    torch.cuda.empty_cache()
    n_per = len(budget.w2s_sizes)
    emit({"phase": "8.7 resync (a) packed", "args": RESYNC_ARGS,
          "losses": losses, "step_s": step_s, "lags": lags,
          "resync_replayed": counts[0], "resync_full": counts[1],
          "w_w_bit_equal_w": current, "peak_mem_bytes": peak,
          "predicted_peak_mem_bytes": PEAK_RESYNC_PREDICTED,
          "two_way_packed_peak_mem_bytes": two_way["peak"],
          "gathered_per_step": gathered[:n_per],
          "broadcast_per_step": broadcast[:len(budget.s2w_sizes)],
          "launches": launches, "natural_decode_per_step":
          launches["natural_decode"] / RESYNC_STEPS,
          "natural_decode_per_step_predicted":
          want["natural_decode"] / RESYNC_STEPS})
    if not all(math.isfinite(v) for v in losses):
        fail(f"resync (a): non-finite losses {losses}")
    if lags != RESYNC_LAGS or counts != [1, 1]:
        fail(f"resync (a): lags {lags}, replayed/full {counts}; expected "
             f"{RESYNC_LAGS}, [1, 1]")
    if not all(current.values()):
        fail(f"resync (a): W_j not bit-equal to W: {current}")
    if gathered != two_way["gathered"][:n_per] * RESYNC_STEPS \
            or broadcast != two_way["broadcast_bytes"][
                :len(budget.s2w_sizes)] * RESYNC_STEPS:
        fail(f"resync (a): gathers {gathered[:n_per]} or broadcasts "
             f"{broadcast[:3]} a step differ from the two-way run's")
    if launches != want:
        fail(f"resync (a): launches {launches}, the layouts imply {want}")
    # (a) without resync: the same x, W and EF21 state (an absent worker's
    # gradient, the only one taken at a stale W_j, is masked out), and
    # its steps beside (a)'s
    off_argv = [a for a in RESYNC_ARGS]
    del off_argv[off_argv.index("--resync"):off_argv.index("--resync") + 2]
    off_args = train_cli.parse_args(off_argv)
    _, tr_off, _, _ = train_cli.setup(off_args, group=group)
    off = train_cli.run_steps(tr_off, tr_off.init(off_args.seed), data,
                              sched, RESYNC_STEPS)
    off_state = off.pop("state")
    same_off = all(same_state(to_host(off_state[k]), final[k]) for k in
                   ("x", "w", "g_server", "g_w", "m_w"))
    del off_state, off["aux"], tr_off
    torch.cuda.empty_cache()
    emit({"check": "8.7 resync (a) against the same run without resync",
          "x_w_and_ef21_state_bit_equal": same_off,
          "losses_without": off["losses"], "step_s": step_s,
          "step_s_without": off["step_s"]})
    if not same_off:
        fail("resync (a): x, W or the EF21 state differ from the run "
             "without resync")
    # (b) everyone present: the two-way run's bits
    full_args = train_cli.parse_args(TWO_WAY_ARGS + ["--resync",
                                                     str(RESYNC_R)])
    b = packed_run(full_args, group, STEPS * per_step, keep_state=True)
    same_b = (b["losses"] == two_way["losses"]
              and same_state(b["x"], two_way["x"])
              and same_state(b["w"], two_way["w"]))
    emit({"phase": "8.7 resync (b) everyone present", "losses": b["losses"],
          "two_way_losses": two_way["losses"], "bit_equal": same_b,
          "step_s": b["step_s"], "two_way_step_s": two_way["step_s"],
          "peak_mem_bytes": b["peak"],
          "natural_decode_per_step": b["launches"]["natural_decode"]
          / STEPS})
    if not same_b:
        fail("resync (b): losses, x or w not bit-equal to the two-way run")
    del b
    torch.cuda.empty_cache()
    replay = replay_profile(group)
    # (c) unpacked, through the CLI, with its final checkpoint
    path_c = str(phase8_dir() / "resync_final")
    want_c = expected_launches(tr, RESYNC_STEPS * per_step, packed=False,
                               steps=RESYNC_STEPS)
    reset_all_launches()
    c = train_cli.main(RESYNC_ARGS + ["--checkpoint", path_c])
    launches_c = all_launches()
    torch.cuda.empty_cache()
    # loaded on the host, beside (a)'s final state (the ring's bytes
    # follow the arm's layout: the unpacked row is the monolithic pack)
    like = state_template(final)
    got, cstep = load_checkpoint(path_c, like)
    same_c = (c["losses"] == losses and cstep == RESYNC_STEPS
              and all(same_state(got[k], final[k]) for k in
                      ("x", "w", "w_w", "g_server", "g_w", "m_w"))
              and torch.equal(got["resync"]["vv"], final["resync"]["vv"]))
    del got
    w_served, version = serve_full_resync(path_c, like)
    served = version == RESYNC_STEPS and same_state(w_served, final["w"])
    del w_served
    os.remove(path_c + ".npz")
    summary = {k: c["summary"][k] for k in ("resync_replayed", "resync_full",
                                            "version_lag_max")}
    emit({"phase": "8.7 resync (c) unpacked, the CLI", "losses": c["losses"],
          "summary": summary, "bit_equal_to_a": same_c,
          "serve_full_resync": {"version": version, "w_bit_equal": served},
          "step_s": c["step_s"], "launches": launches_c})
    if summary != {"resync_replayed": 1, "resync_full": 1,
                   "version_lag_max": 0} or not same_c or not served:
        fail(f"resync (c): summary {summary}, bit-equal to (a) {same_c}, "
             f"served W {served} (version {version})")
    if launches_c != want_c:
        fail(f"resync (c): launches {launches_c}, the layouts imply "
             f"{want_c}")
    # (d) checkpointed after RESYNC_RESUME_AT steps, resumed
    path_d = str(phase8_dir() / "resync_resume")
    head = train_cli.run_steps(tr, tr.init(args.seed), data, sched,
                               RESYNC_RESUME_AT)
    behind = head["lags"][-1]
    like = state_template(head["state"])
    save_checkpoint(path_d, head.pop("state"), step=RESYNC_RESUME_AT)
    del head["aux"]
    torch.cuda.empty_cache()
    resumed, rstep = load_checkpoint(path_d, like)
    tail = train_cli.run_steps(tr, resumed, data, sched, RESYNC_STEPS,
                               start=rstep)
    del resumed
    same_d = (head["losses"] + tail["losses"] == losses
              and same_state(to_host(tail.pop("state")), final))
    os.remove(path_d + ".npz")
    del tail
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    emit({"phase": "8.7 resync (d) checkpoint and resume",
          "rounds_behind_at_the_checkpoint": behind,
          "resumed_at": RESYNC_RESUME_AT, "bit_equal_to_a": same_d,
          "nan_bits": nan, "replay_profile": replay, "phase_wall_s": wall})
    if behind != 2 or not same_d:
        fail(f"resync (d): {behind} rounds behind at the checkpoint, the "
             f"resumed run bit-equal to (a): {same_d}")
    return {"launches": launches, "peak": peak, "step_s": step_s,
            "nan_bits": nan, "losses": losses, "x": final["x"],
            "w": final["w"], "gathered": gathered, "broadcast": broadcast}


# ------------------------------------------------------------- phase 9
# two ranks of one worker each on the one card, over a gloo group (NCCL
# refuses two ranks on one device): the packed two-way run and phase
# 8.7's drop run with --resync, each bit-equal to its one-rank run
TWO_RANK_JOIN_S = 600
# each rank's peak of the two-way run, below the one-rank run's (2
# workers): PERF.md §6 predicts it one worker's state lower
PEAK_TWO_WAY_ONE_RANK = 18_582_422_016


def digest(tree) -> str:
    """sha256 of every tensor's bytes of a tree, in tree order."""
    import hashlib
    import torch
    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                     .cpu().numpy().tobytes())
    walk(tree)
    return h.hexdigest()


# the placements the two ranks run the packed two-way step under beside
# the plain one: the server's state cut by the zero-1 and the FSDP rules
PLACEMENTS = {"zero1": {"zero1_lmo": True}, "fsdp": {"fsdp": True}}
# reduced mixtral over the two ranks with zero-1: its expert stacks [L,
# E, ...] (two stack dims) through the bucket split
MOE_RANK_ARGS = ["--arch", "mixtral-8x7b", "--reduced", "--steps", "3",
                 "--seq", "32", "--batch", "4", "--workers", "2",
                 "--w2s", "top10+natural", "--s2w", "natural",
                 "--beta", "0.5", "--device", "cuda"]
# the two largest full-width buckets (PERF.md §6): the NS chain on the
# whole, a half and a quarter of each, a rank's LMO on 2 and 4 cards
SPLIT_BUCKETS = {"qwen2.5-3b": (24, 2048, 11008),
                 "mixtral-8x7b": (24, 4096, 14336)}


def record_ns_stacks(record: list) -> None:
    """Patch the NS chain (``kernels.ops._iterate``) to append the shape
    of every stack it is handed to ``record``."""
    from repro_torch.kernels import ops
    plain = ops._iterate

    def iterate(x, steps, coeffs):
        record.append(list(x.shape))
        return plain(x, steps, coeffs)

    ops._iterate = iterate


def spec_bytes(tr) -> dict:
    """The bytes of x, w and g_server one rank holds between steps, as
    ``tr.state_specs()`` cuts each leaf (w and g_server in f32)."""
    from repro_torch.dist.layerwise import leaf_paths, tree_get
    p = tr.group.size()
    specs, shapes = tr.state_specs()["x"], tr._params_shapes
    out = {"x": 0, "w": 0, "g_server": 0}
    for path in leaf_paths(shapes):
        t = tree_get(shapes, path)
        n = t.numel() // (p if "data" in tree_get(specs, path) else 1)
        out["x"] += n * t.element_size()
        out["w"] += n * 4
        out["g_server"] += n * 4
    return out


def held_bytes(state) -> dict:
    from repro_torch.dist.layerwise import tree_leaves
    return {k: sum(t.numel() * t.element_size() for t in tree_leaves(state[k]))
            for k in ("x", "w", "g_server")}


def p5_device_ms(tr, state, data, sched, step: int) -> float:
    """Phase 5's device ms of one more step from ``state``, under
    torch.profiler, through a trainer like ``tr`` with trace spans (bit
    neutral) on."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_step import span_device_ms
    from repro_torch.obs.trace import PHASE_SPANS
    from repro_torch.train.trainer import Trainer
    trp = Trainer(tr.model, dataclasses.replace(tr.tcfg, trace_spans=True),
                  device=tr.device, group=tr.group)
    step_fn = trp.make_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, aux = step_fn(state, data.batch_at(step), sched(step - 1))
        float(aux["loss"])
        torch.cuda.synchronize()
    del state, aux
    return span_device_ms(prof.events())[0][PHASE_SPANS[4]]


def two_rank_child(rank: int, tmp: str) -> None:
    """One of phase 9's two ranks: the two runs over the gloo group, the
    packed two-way run under the zero-1 and FSDP placements, reduced
    mixtral with zero-1 (and on rank 0 over a one-rank group), then the
    host-staged gather and broadcast of each stage buffer timed alone;
    writes what the parent checks to ``tmp/rank<r>.json``."""
    import dataclasses
    import os
    import traceback
    sys.path.insert(0, str(SRC))
    out: dict = {}
    try:
        import torch
        import torch.distributed as dist
        from repro_torch.dist import sharding
        from repro_torch.launch import train as train_cli
        from repro_torch.train.trainer import Trainer
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        store = dist.FileStore(os.path.join(tmp, "store"), 2)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=2)
        group = dist.group.WORLD
        solo = dist.new_group([0])      # rank 0's one-rank group
        stacks: list = []
        record_ns_stacks(stacks)
        runs = [("two_way", TWO_WAY_ARGS, STEPS, {}),
                ("resync", RESYNC_ARGS, RESYNC_STEPS, {})]
        runs += [(name, TWO_WAY_ARGS, STEPS, kw)
                 for name, kw in PLACEMENTS.items()]
        for name, argv, steps, kw in runs:
            args = train_cli.parse_args(argv)
            _, tr, data, sched = train_cli.setup(args, group=group)
            if kw:
                tr = Trainer(tr.model, dataclasses.replace(tr.tcfg, **kw),
                             device=tr.device, group=group)
            budget = tr.wire_budget()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stacks.clear()
            reset_all_launches()
            t0 = time.perf_counter()
            run = train_cli.run_steps(tr, tr.init(args.seed), data, sched,
                                      steps)
            torch.cuda.synchronize()
            state = run.pop("state")
            out[name] = {
                "launches": all_launches(),
                "workers": [tr.workers.start, tr.workers.stop],
                "losses": run["losses"], "step_s": run["step_s"],
                "lags": run["lags"], "wall_s": time.perf_counter() - t0,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "gathered": tr.gathered, "broadcast": tr.broadcast_bytes,
                "aux_gathered": tr.aux_gathered,
                "w2s_sizes": list(budget.w2s_sizes),
                "ns_stacks": list(stacks),
                "buckets": [[b.batch, *b.shape] for b in
                            tr.layer_plan().ns_buckets(mesh=tr.mesh)],
                "held_bytes": held_bytes(state),
                "spec_bytes": spec_bytes(tr)}
            if name != "resync":
                out[name]["p5_device_ms"] = p5_device_ms(tr, state, data,
                                                         sched, steps)
            n0 = len(tr.state_gathered)
            whole = tr.gather_server(state, to_host=True)
            out[name].update(x=digest(whole["x"]), w=digest(whole["w"]),
                             state_gathered_per_step=len(
                                 tr.state_gathered[:n0]) / steps,
                             state_gathered_bytes_per_step=sum(
                                 tr.state_gathered[:n0]) / steps)
            del state, whole, run, tr
            torch.cuda.empty_cache()
        # reduced mixtral: rank 0 alone over its one-rank group, then
        # both ranks with zero-1
        args = train_cli.parse_args(MOE_RANK_ARGS)
        moe = {}
        for name, grp, kw in (("one_rank", solo, {}),
                              ("zero1", group, {"zero1_lmo": True})):
            if grp is solo and rank != 0:
                continue
            _, tr, data, sched = train_cli.setup(args, group=grp)
            tr = Trainer(tr.model, dataclasses.replace(tr.tcfg, **kw),
                         device=tr.device, group=grp)
            stacks.clear()
            run = train_cli.run_steps(tr, tr.init(args.seed), data, sched,
                                      args.steps)
            whole = tr.gather_server(run.pop("state"), to_host=True)
            moe[name] = {"losses": run["losses"], "x": digest(whole["x"]),
                         "w": digest(whole["w"]),
                         "g_server": digest(whole["g_server"]),
                         "ns_stacks": list(stacks),
                         "buckets": [[b.batch, *b.shape] for b in
                                     tr.layer_plan().ns_buckets()]}
            del whole, run, tr
        out["moe"] = moe
        torch.cuda.empty_cache()
        # the wire's collectives alone: each stage buffer through the
        # host-staged gather and broadcast (a copy to pinned memory, gloo
        # over the loopback, a copy back), not a link between cards
        sizes = out["two_way"]["w2s_sizes"]
        s2w = [NANOGPT_WIRE["s2w"]["natural"][k]
               for k in NANOGPT_WIRE["order"]]
        times = {"gather_s": [], "broadcast_s": []}
        for _ in range(3):
            for key, nbytes, fn in (
                    [("gather_s", n, sharding.gather_tensor) for n in sizes]
                    + [("broadcast_s", n, sharding.broadcast_tensor)
                       for n in s2w]):
                buf = torch.full((1, nbytes), rank, dtype=torch.uint8,
                                 device="cuda")
                dist.barrier(group)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(buf, group)
                torch.cuda.synchronize()
                times[key].append(time.perf_counter() - t0)
        out["collective_s"] = {"w2s_sizes": sizes, "s2w_sizes": s2w, **times}
        dist.barrier(group)
        torch.cuda.empty_cache()
        # ---- 9s the supervisor over the two ranks; its last run ends
        # rank 1, which writes what it has first
        out["supervised"] = {}

        def dump():
            with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
                json.dump(out, f)
        supervised_runs(rank, tmp, store, out["supervised"], dump)
    except Exception:
        out["error"] = traceback.format_exc()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    # the peer is gone and abandoned attempts may wait in collectives of
    # old generations: no teardown
    os._exit(0)


# ------------------------------------------------------------ phase 9s
# the supervisor over phase 9's two ranks (train/supervisor.py): (a) a
# raise on rank 1 at step 1, (b) rank 1 wedged in its first gather of step
# 2 past the deadline, (c) a checkpoint every 2 steps and rank 0 raising
# on every attempt of step 3 (a reload), (d) rank 1 exiting at step 1.
# (a) and (b) against phase 9's two-way run; (c) and (d) at CKPT_DEPTH
# layers (every width), against the same run unsupervised. A full-width
# two-rank step takes ~0.8 s (PERF.md §6)
S9_TIMEOUT_S = 6.0
S9_WEDGE_S = S9_TIMEOUT_S + 0.5      # wakes during the retry
# (d)'s deadline: a step at CKPT_DEPTH layers takes ~0.4 s, and rank 0
# names the dead rank 2 x this after the attempt began
S9_DEAD_TIMEOUT_S = 3.0
S9_EVENTS = {
    "raise": [["retry", 1, 0, None]],
    "wedge": [["timeout", 2, 0, None]],
    "reload": [["checkpoint", 1, 0, None], ["retry", 3, 0, None],
               ["retry", 3, 1, None], ["retry", 3, 2, None],
               ["reload", 3, 2, 2], ["checkpoint", 3, 0, None]]}


class StepFaults:
    """A wrapper around the step of a ``trainer_class`` trainer and around
    the all-gather (``dist.sharding.gather_tensor``): at the (step,
    attempt, visit) ``arm`` names, raise, wedge (one sleep of S9_WEDGE_S
    in the first gather of the attempt's thread) or exit the process
    (after ``dump``).
    Steps are known by their batch (``Tagged``), a visit (one
    ``run_step``, the first 0) by the batch object, attempts by the calls
    with it; the time each attempt ended goes to ``log["ends"]``."""

    def __init__(self, rank: int, dump):
        self.rank, self.dump = rank, dump
        self.arm({})

    def trainer_class(self):
        """A ``Trainer`` whose step runs ``before`` first; a supervisor's
        generations keep its class (``Trainer.regroup``)."""
        from repro_torch.train.trainer import Trainer
        faults = self

        class FaultyTrainer(Trainer):
            def make_step(self):
                step = super().make_step()

                def wrapped(state, batch, t):
                    at = faults.before(batch)
                    out = step(state, batch, t)
                    faults.log["ends"][at] = time.time()
                    return out
                return wrapped
        return FaultyTrainer

    def install(self) -> None:
        import threading
        from repro_torch.dist import sharding
        gather = sharding.gather_tensor
        faults = self

        def wrapped_gather(*a, **k):
            if faults.wedge == threading.get_ident():
                faults.wedge = None
                faults.log["wedged_at"] = time.time()
                time.sleep(S9_WEDGE_S)
                faults.log["woke_at"] = time.time()
            return gather(*a, **k)

        sharding.gather_tensor = wrapped_gather

    def arm(self, actions: dict) -> None:
        self.actions, self.calls, self.wedge = actions, [], None
        self.log = {"ends": {}}

    def before(self, batch) -> str:
        import threading
        entry = next((c for c in self.calls if c[0] is batch), None)
        if entry is None:
            visit = sum(c[0].step == batch.step for c in self.calls)
            entry = [batch, 0, visit]
            self.calls.append(entry)
        attempt, entry[1] = entry[1], entry[1] + 1
        at = f"{batch.step}/{attempt}"
        action = self.actions.get((batch.step, attempt, entry[2]))
        if action == "raise":
            raise RuntimeError(f"injected on rank {self.rank} at step {at}")
        if action == "wedge":
            self.wedge = threading.get_ident()
        if action == "exit":
            self.dump()
            with open(self.exit_path, "w") as f:
                json.dump({"t": time.time()}, f)
            os._exit(0)
        return at


class Tagged:
    """A data stream whose batches know their step."""

    class Batch(dict):
        pass

    def __init__(self, data):
        self.data = data

    def batch_at(self, i: int):
        b = Tagged.Batch(self.data.batch_at(i))
        b.step = i
        return b


class EventLog:
    """A writer that keeps the supervisor's recovery events."""

    def __init__(self):
        self.events = []

    def write(self, kind: str, **f) -> None:
        if kind == "recovery":
            self.events.append([f["event"], f["step"], f["attempt"],
                                f.get("resumed_step")])


def supervised_runs(rank: int, tmp: str, store, out: dict, dump) -> None:
    """9s in one of phase 9's ranks: the four runs, each into ``out``
    (the depth-cut one first unsupervised); rank 1 ends in (d)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.train.checkpoint import state_template
    from repro_torch.train.supervisor import (Supervisor, SupervisorConfig,
                                              SupervisorError)
    group = dist.new_group([0, 1])
    faults = StepFaults(rank, dump)
    faults.exit_path = os.path.join(tmp, "exit9s.json")
    faults.install()
    faulty = faults.trainer_class()
    args = train_cli.parse_args(TWO_WAY_ARGS)
    cut = get_config("nanogpt-124m").with_depth(CKPT_DEPTH)
    runs = (("raise", None, {1: {(1, 0, 0): "raise"}}, False),
            ("wedge", None, {1: {(2, 0, 0): "wedge"}}, False),
            ("plain_cut", cut, None, False),
            ("reload", cut, {0: {(3, a, 0): "raise" for a in range(3)}},
             True),
            ("dead", cut, {1: {(1, 0, 0): "exit"}}, False))
    for name, cfg, actions, ckpt in runs:
        _, tr, data, sched = train_cli.setup(args, group=group, cfg=cfg)
        state = tr.init(args.seed)
        sup = None
        if actions is not None:
            tr = faulty(tr.model, tr.tcfg, device=tr.device, group=group)
            sup = Supervisor(SupervisorConfig(
                step_timeout_s=(S9_DEAD_TIMEOUT_S if name == "dead"
                                else S9_TIMEOUT_S),
                checkpoint_path=(os.path.join(tmp, "ck9s") if ckpt
                                 else None),
                checkpoint_every=2 if ckpt else 0),
                writer=EventLog(), state_like=state_template(state),
                group=group, store=store, trainer=tr)
        faults.arm((actions or {}).get(rank, {}))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        t0 = time.perf_counter()
        res = out[name] = {}
        try:
            run = train_cli.run_steps(tr, state, Tagged(data), sched,
                                      args.steps, sup=sup)
        except SupervisorError as e:
            res.update(error=str(e), t_error=time.time(),
                       wall_s=time.perf_counter() - t0,
                       events=sup.writer.events)
            continue
        del state
        torch.cuda.synchronize()
        res.update(losses=run["losses"], step_s=run["step_s"],
                   wall_s=time.perf_counter() - t0,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   launches=all_launches())
        if sup is not None:
            budget = sup.current.wire_budget()
            res.update(events=sup.writer.events, retries=sup.retries,
                       reloads=sup.reloads, generation=sup.generation,
                       gathered=sup.current.gathered,
                       broadcast=sup.current.broadcast_bytes,
                       w2s_sizes=[sup.current.n_local * n
                                  for n in budget.w2s_sizes],
                       log=dict(faults.log))
        whole = tr.gather_server(run.pop("state"), to_host=True)
        res.update(x=digest(whole["x"]), w=digest(whole["w"]))
        del whole, run, tr, sup
        if name == "wedge":
            # the orphans finish their step on generation 0 (or time out)
            t_end = time.time()
            while "woke_at" not in faults.log \
                    and time.time() < t_end + S9_WEDGE_S:
                time.sleep(0.05)
            res["log"] = dict(faults.log)
        torch.cuda.empty_cache()


def supervised_report(got: list, smi: str, exit_t: float | None) -> dict:
    """9s in the parent: each run's checks on both ranks (the comment
    above S9_TIMEOUT_S), ``exit_t`` the time rank 1 exited; returns the
    phase's line."""
    want_b = [NANOGPT_WIRE["s2w"]["natural"][k]
              for k in NANOGPT_WIRE["order"]]
    bad, rows = [], []
    for r, res in enumerate(got):
        sup = res["supervised"]
        one = res["two_way"]
        row = {"rank": r}
        for name in ("raise", "wedge", "reload"):
            run = sup.get(name, {})
            if "error" in run or "losses" not in run:
                bad.append(f"rank {r} {name}: {run.get('error')}")
                continue
            ref = one if name != "reload" else sup["plain_cut"]
            losses = list(run["losses"])
            if name == "reload":
                # steps 0-3, then steps 2-3 again from the archive
                if losses[3:4] != ref["losses"][2:3]:
                    bad.append(f"rank {r} reload: step 2 again "
                               f"{losses[3:4]} vs {ref['losses'][2:3]}")
                del losses[3]
            if losses != ref["losses"]:
                bad.append(f"rank {r} {name} losses {run['losses']} vs "
                           f"{ref['losses']}")
            for key in ("x", "w"):
                if run[key] != ref[key]:
                    bad.append(f"rank {r} {name} {key} differs")
            if run["events"] != S9_EVENTS[name]:
                bad.append(f"rank {r} {name} events {run['events']}")
            row[name] = {k: run[k] for k in (
                "losses", "step_s", "wall_s", "peak_mem_bytes", "retries",
                "reloads", "generation", "events")}
        raised, wedged = sup.get("raise", {}), sup.get("wedge", {})
        if "step_s" in raised and not raised["step_s"][1] < S9_TIMEOUT_S:
            bad.append(f"rank {r} waited {raised['step_s'][1]} s after "
                       "rank 1 raised")
        if "launches" in raised:
            row["raise"]["launches"] = raised["launches"]
            short = [k for k, n in one["launches"].items()
                     if raised["launches"].get(k, 0) < n]
            if short:
                bad.append(f"rank {r} raise launched fewer {short} than "
                           "the unsupervised run")
        if "gathered" in wedged:
            if wedged["generation"] != 1 \
                    or wedged["gathered"] != wedged["w2s_sizes"] * 2 \
                    or wedged["broadcast"] != want_b * 2:
                bad.append(f"rank {r} wedge: generation "
                           f"{wedged['generation']}, gathers "
                           f"{wedged['gathered']}, broadcasts "
                           f"{wedged['broadcast']}")
            row["wedge"]["two_way_peak_mem_bytes"] = one["peak_mem_bytes"]
            row["wedge"]["ends"] = wedged["log"]["ends"]
        rows.append(row)
    # the seconds from the wedge to each rank's retry of step 2 ending
    log1 = got[1]["supervised"].get("wedge", {}).get("log", {})
    for r, row in enumerate(rows):
        end = got[r]["supervised"].get("wedge", {}).get(
            "log", {}).get("ends", {}).get("2/1")
        if "wedged_at" in log1 and end is not None:
            row["wedge"]["fault_to_retry_end_s"] = end - log1["wedged_at"]
            row["wedge"]["orphan_woke_during_retry"] = (
                log1.get("woke_at", end + 1) < end)
    dead = got[0]["supervised"].get("dead", {})
    took = (dead["t_error"] - exit_t if exit_t and "t_error" in dead
            else None)
    if not ("error" in dead and "[1]" in dead["error"]) or took is None \
            or not took <= 2 * S9_DEAD_TIMEOUT_S + 5:
        bad.append(f"rank 0 on rank 1's exit: {dead.get('error')} after "
                   f"{took} s")
    report = {"phase": "9s the supervisor over the two ranks",
              "card": smi, "step_timeout_s": S9_TIMEOUT_S,
              "wedge_s": S9_WEDGE_S, "depth_of_reload_and_dead": CKPT_DEPTH,
              "ranks": rows, "dead_rank_named_after_s": took,
              "dead_rank_error": dead.get("error"),
              "dead_rank_timeout_s": S9_DEAD_TIMEOUT_S,
              "dead_rank_limit_s": 2 * S9_DEAD_TIMEOUT_S + 5}
    emit(report)
    if bad:
        fail("9s: " + "; ".join(bad))
    return report


def two_rank_run(two_way: dict, resynced: dict, one_p5_ms: float,
                 smi: str) -> dict:
    """9: two processes on cuda:0 over a gloo group, one worker each:
    the packed two-way run, phase 8.7's drop run with --resync, and the
    two-way run under the zero-1 and the FSDP placements. Fails unless
    every rank's losses, x and W are bit-equal to the one-rank runs',
    each rank gathered its one worker's w2s stage bytes and received the
    s2w stage buffers in issue order every step, and each rank's two-way
    peak is below the one-rank run's; for the placements, unless each
    rank's NS chains took ``[B/2, m, n]`` of every bucket, it held the
    specs' bytes of x, w and g_server, and its peak is at or below the
    plain two-rank run's; and unless reduced mixtral with zero-1 is
    bit-equal to the one-rank group's run. ``one_p5_ms`` is the one-rank
    two-way run's phase-5 device ms (8.6), printed beside the ranks'."""
    import shutil
    import tempfile
    import torch
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        ctx = mp.start_processes(two_rank_child, args=(tmp,), nprocs=2,
                                 join=False, start_method="spawn")
        deadline = time.time() + TWO_RANK_JOIN_S
        done = False
        try:
            while not done and time.time() < deadline:
                done = ctx.join(timeout=5)
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        if not done:
            fail(f"two ranks: not done in {TWO_RANK_JOIN_S} s")
        got = []
        for r in range(2):
            with open(f"{tmp}/rank{r}.json") as f:
                got.append(json.load(f))
            if "error" in got[r]:
                fail(f"two ranks: rank {r} raised:\n{got[r]['error']}")
        exit_t = None
        if os.path.exists(f"{tmp}/exit9s.json"):
            with open(f"{tmp}/exit9s.json") as f:
                exit_t = json.load(f)["t"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want_b = [NANOGPT_WIRE["s2w"]["natural"][k]
              for k in NANOGPT_WIRE["order"]]
    ref = {"two_way": (two_way, STEPS), "resync": (resynced, RESYNC_STEPS),
           **{name: (two_way, STEPS) for name in PLACEMENTS}}
    report = {"phase": "9 two ranks on cuda:0 over gloo, one worker each",
              "wall_s": time.perf_counter() - t_phase, "ranks": []}
    bad = []
    for r, res in enumerate(got):
        row = {"rank": r, "collective_s": res["collective_s"]}
        for name, (one, steps) in ref.items():
            run = res[name]
            row[name] = {k: run[k] for k in (
                "workers", "losses", "step_s", "wall_s", "peak_mem_bytes",
                "lags", "aux_gathered", "held_bytes", "spec_bytes",
                "state_gathered_per_step", "state_gathered_bytes_per_step")
                if k in run}
            if "p5_device_ms" in run:
                row[name]["p5_device_ms"] = run["p5_device_ms"]
                row[name]["one_rank_p5_device_ms"] = one_p5_ms
            # every bucket 2 divides reaches the chain as its half
            want_stacks = sorted([b // 2 if b % 2 == 0 else b, m, n]
                                 for b, m, n in run["buckets"]) * steps
            row[name]["ns_stacks_per_step"] = run["ns_stacks"][
                :len(run["buckets"])]
            if sorted(run["ns_stacks"]) != sorted(want_stacks):
                bad.append(f"rank {r} {name} NS chains took "
                           f"{run['ns_stacks'][:4]}, expected halves of "
                           f"{run['buckets']}")
            if run["held_bytes"] != run["spec_bytes"]:
                bad.append(f"rank {r} {name} holds {run['held_bytes']}, the "
                           f"specs give {run['spec_bytes']}")
            if name in PLACEMENTS and run["peak_mem_bytes"] \
                    > res["two_way"]["peak_mem_bytes"]:
                bad.append(f"rank {r} {name} peak {run['peak_mem_bytes']} B "
                           "above the plain two-rank run's "
                           f"{res['two_way']['peak_mem_bytes']} B")
            row[name]["gathered_per_step"] = run["gathered"][:3]
            row[name]["broadcast_per_step"] = run["broadcast"][:3]
            if run["losses"] != one["losses"]:
                bad.append(f"rank {r} {name} losses {run['losses']} vs "
                           f"{one['losses']}")
            for key in ("x", "w"):
                if run[key] != digest(one[key]):
                    bad.append(f"rank {r} {name} {key} differs")
            if run["workers"] != [r, r + 1]:
                bad.append(f"rank {r} owns workers {run['workers']}")
            if sum(run["w2s_sizes"]) \
                    != NANOGPT_WIRE["w2s"]["top10+natural"] \
                    or run["gathered"] != run["w2s_sizes"] * steps:
                bad.append(f"rank {r} {name} gathered {run['gathered'][:3]}"
                           f" a step, budget {run['w2s_sizes']}")
            if run["broadcast"] != want_b * steps:
                bad.append(f"rank {r} {name} received {run['broadcast'][:3]}"
                           f" a step, expected {want_b}")
        if row["two_way"]["peak_mem_bytes"] >= PEAK_TWO_WAY_ONE_RANK:
            bad.append(f"rank {r} two-way peak "
                       f"{row['two_way']['peak_mem_bytes']} B")
        report["ranks"].append(row)
    moe = got[0]["moe"]["one_rank"]
    report["moe_zero1"] = {"losses": moe["losses"],
                           "buckets": moe["buckets"]}
    for r, res in enumerate(got):
        cut = res["moe"]["zero1"]
        for key in ("losses", "x", "w", "g_server"):
            if cut[key] != moe[key]:
                bad.append(f"rank {r} reduced mixtral zero-1 {key} differs "
                           "from the one-rank group's")
        want = sorted([b // 2 if b % 2 == 0 else b, m, n]
                      for b, m, n in moe["buckets"]) * len(moe["losses"])
        if sorted(cut["ns_stacks"]) != sorted(want) \
                or not any(b % 2 == 0 for b, _, _ in moe["buckets"]):
            bad.append(f"rank {r} reduced mixtral NS chains took "
                       f"{cut['ns_stacks'][:6]}")
    report["peak_sum_two_way"] = sum(
        row["two_way"]["peak_mem_bytes"] for row in report["ranks"])
    report["one_rank_peak_two_way"] = two_way["peak"]
    report["one_rank_peak_resync"] = resynced["peak"]
    emit(report)
    if bad:
        fail("two ranks: " + "; ".join(bad))
    report["supervised"] = supervised_report(got, smi, exit_t)
    return report


def split_bucket_rows(dev, gen, smi: str) -> list[dict]:
    """9b: the NS chain (5 iterations, the LMO's) on the whole, a half and
    a quarter of each ``SPLIT_BUCKETS`` stack, f32 drawn on the card, as
    a rank runs its rows (``newton_schulz_rows``: the norms over the
    whole stack, the iterations on the rows): each part bit-equal to the
    whole stack's rows (the first and the last part), and its device ms,
    the card's forecast of a rank's LMO on 2 and 4 cards."""
    import torch
    from repro_torch.kernels.ops import newton_schulz_rows
    rows = []
    for arch, shape in SPLIT_BUCKETS.items():
        g = torch.randn(shape, generator=gen, device=dev)
        whole = newton_schulz_rows(g, steps=NS_STEPS)
        row = {"arch": arch, "bucket": list(shape), "card": smi,
               "steps": NS_STEPS}
        for parts in (1, 2, 4):
            b = shape[0] // parts
            for part in (range(0, b), range(shape[0] - b, shape[0])) \
                    if parts > 1 else ():
                got = newton_schulz_rows(g, part, steps=NS_STEPS)
                want = whole[part.start:part.stop]
                if not torch.equal(got, want):
                    fail(f"NS chain on slices {part} of {arch}'s "
                         f"{list(shape)} differs from the whole stack's "
                         f"rows: max {float((got - want).abs().max())}")
                del got
            row[f"ms_{b}_of_{shape[0]}"] = time_ms(
                lambda: newton_schulz_rows(g, range(0, b), steps=NS_STEPS),
                reps=3, warmup=1)
        row["half_over_whole"] = row[f"ms_{shape[0] // 2}_of_{shape[0]}"] \
            / row[f"ms_{shape[0]}_of_{shape[0]}"]
        row["quarter_over_whole"] = \
            row[f"ms_{shape[0] // 4}_of_{shape[0]}"] \
            / row[f"ms_{shape[0]}_of_{shape[0]}"]
        rows.append(row)
        del g, whole
        torch.cuda.empty_cache()
    emit({"phase": "9b the NS chain on a rank's share of the largest "
          "buckets", "rows": rows})
    return rows


# ------------------------------------------------------------ phase 9c
# Training over the reference's (data, model) mesh: nanogpt-124m at full width
# (MESH_DEPTH layers) on data=2 x model=2, four processes on cuda:0 over gloo
# (NCCL refuses two ranks on one device, so every collective goes through
# pinned host memory: its times are not a link's). Each data row's two ranks
# run one worker's forward and backward together, the weights cut on model as
# param_pspecs says; the packed two-way step (top10+natural, --s2w natural)
# with the MetricSet on, held against one process's run of the same config,
# seed and batches (its losses, and step 0's MetricSet), and step 0's state
# against a metrics-off step, bit for bit. Then each NS bucket's chain at the
# chunk shapes a rank runs (the columns cut: the gram partials summed over the
# model pair; the rows cut: the whole chain on the rank's data rows) against
# its plain version and against the whole chain.
#
# ------------------------------------------------------------ phase 9d
# Training over the reference's multi-pod mesh: the same run on pod=2 x
# data=2 x model=1, four processes on cuda:0 over gloo. The EF21 workers
# go on pod (one a pod), each worker's two rows on data (one a rank), so
# each rank runs one row's forward and backward and the gradient is
# summed over its data pair (row_grad); the wire moves over the pod
# pairs; each NS bucket splits over (pod, data), pod-major. Held against
# the same one-process run; then each bucket's chain at a rank's (pod,
# data) rows against its plain version.
MESH_TRAIN = {"data": 2, "model": 2}
MESH_POD = {"pod": 2, "data": 2, "model": 1}
MESH_STEPS = 3
# every width at 4 of 12 layers: a step's host-staged collectives follow
# its bytes, and at 12 layers 9c and 9d took 62 and 30 s on one machine
# and 121 and 64 s on another (PERF.md §6)
MESH_DEPTH = 4
MESH_ARGS = ["--arch", "nanogpt-124m", "--steps", str(MESH_STEPS),
             "--seq", "1024", "--batch", "4", "--workers", "2",
             "--w2s", "top10+natural", "--s2w", "natural", "--beta", "0.5",
             "--log-every", "1", "--device", "cuda"]
MESH_JOIN_S = 420
TOL_MESH_LOSS = 1e-3     # step 0's loss, (1 + |loss|), vs one process
# steps 1 and 2, (1 + |loss|), vs one process. The schedule's radius is 0
# at step 0, so step 1's loss is the forward of the untouched weights on a
# new batch (bit-equal to one process's in every run so far); step 2's
# follows the first update, 3.8e-4 from one process's at 10.604 (4 ranks
# alike, in each of three runs on an NVIDIA H100 80GB HBM3, 700 W:
# the column-cut grams' partial sums and the mesh's summation order move
# a TopK pick), where the update itself moved the loss by 0.38
TOL_MESH_LOSS_STEP = (1e-4, 2e-4)
MESH_KEYS = ("x", "w", "g_server", "g_w", "m_w")
# step 0's MetricSet on a mesh rank against one process's fed the same
# gradients, (1 + |v|)
TOL_MESH_METRIC = 1e-5
# ... and against one process's own run, whose bf16 gradients part from
# the ranks' in their last bits and move TopK's picks: 1.59e-4 at 9c and
# 1.36e-4 at 9d on an NVIDIA H100 80GB HBM3, 700 W. A norm left unsummed
# over a cut (a factor of up to sqrt(2) at 2 ranks) is far above it
TOL_MESH_METRIC_OWN = 1e-3
MESH_KERNELS = ("ns_iteration", "fused_matmul", "natural_encode",
                "pack_bits", "natural_decode", "narrow_encode",
                "narrow_decode")


def _plain_ns(x, steps: int, gram_sum=None):
    """The NS chain's plain version on a normalised ``[B, m, n]`` stack
    (``kernels.ref``), or, with ``gram_sum``, on a rank's columns with
    the partial grams summed by it."""
    from repro_torch.kernels.ref import (NS_COEFFS, fused_matmul_ref,
                                         ns_iteration_batched_ref,
                                         syrk_upper_ref)
    a, b, c = NS_COEFFS
    for _ in range(steps):
        if gram_sum is None:
            x = ns_iteration_batched_ref(x)
        else:
            gram = gram_sum(syrk_upper_ref(x))
            poly = syrk_upper_ref(gram, gram, alpha=b, beta=c)
            x = fused_matmul_ref(poly, x, x, alpha=a, beta=1.0)
    return x


def mesh_chunk_chains(tr, dev) -> list[dict]:
    """Each NS bucket of the mesh's plan on a random f32 stack drawn alike
    on every rank: the chain at this rank's chunk shape (the columns
    ``newton_schulz_cols`` runs, or the rows ``newton_schulz_rows`` runs)
    against its plain version on the same inputs and against the whole
    chain's matching part, and each one's ms."""
    import torch
    from repro_torch.kernels.ops import (newton_schulz_cols,
                                         newton_schulz_rows, split_rows)
    rm = tr.rm
    out = []
    for bi, b in enumerate(tr.layer_plan().ns_buckets(mesh=tr.mesh)):
        lead, _, col = b.pspec or (None, None, None)
        gen = torch.Generator(device=dev).manual_seed(1000 + bi)
        g = torch.randn((b.batch,) + b.shape, generator=gen, device=dev)
        # the rows the bucket's lead gives this rank (a composition of
        # axes pod-major, as the reference's PartitionSpec lays it out)
        rows = split_rows(b.batch, pspec=b.pspec, mesh=rm)
        whole = newton_schulz_rows(g, steps=NS_STEPS)
        if rows is not None:
            whole = whole[rows.start:rows.stop]
        eps = 1e-7
        if col == "model":
            def gram_sum(t):
                return rm.sum_partials(t, "gram")

            cols = rm.chunk(g, 2)
            whole = rm.chunk(whole, 2)

            def kernel():
                return newton_schulz_cols(cols, gram_sum, rows, NS_STEPS)

            def plain():
                sq = torch.sum(torch.square(cols), dim=(-2, -1),
                               keepdim=True)
                nrm = torch.sqrt(gram_sum(sq))
                x = cols
                if rows is not None:
                    x, nrm = x[rows.start:rows.stop], nrm[rows.start:rows.stop]
                return _plain_ns(x / (nrm + eps), NS_STEPS, gram_sum)
            kind, shape = "columns", list(cols.shape)
        else:
            def kernel():
                return newton_schulz_rows(g, rows, NS_STEPS)

            def plain():
                nrm = torch.sqrt(torch.sum(torch.square(g), dim=(-2, -1),
                                           keepdim=True))
                x = g
                if rows is not None:
                    x, nrm = x[rows.start:rows.stop], nrm[rows.start:rows.stop]
                return _plain_ns(x / (nrm + eps), NS_STEPS)
            kind, shape = "rows", list(g.shape)
        got, want = kernel(), plain()
        n_rows = b.batch if rows is None else len(rows)
        out.append({
            "bucket": [b.batch, *b.shape], "spec": list(b.pspec or ()),
            "kind": kind, "chunk_shape": [n_rows] + shape[1:],
            "rows": None if rows is None else [rows.start, rows.stop],
            "max_abs_err": float((got - want).abs().max()),
            "vs_whole_chain": float((got - whole).abs().max()),
            "ms": time_ms(kernel, reps=3, warmup=1),
            "plain_ms": time_ms(plain, reps=3, warmup=1)})
        del g, whole, got, want
    return out


def mesh_trainer(args, dev, metrics: bool, group=None, mesh=None):
    """(trainer, data) of MESH_ARGS's run at MESH_DEPTH layers, with or
    without the MetricSet, on one process or as a rank of ``mesh``: its
    data the rows of the rank's workers."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.api import build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg.with_depth(MESH_DEPTH)
    tr = Trainer(build_model(cfg), TrainerConfig(
        n_workers=args.workers, beta=args.beta, w2s=args.w2s, s2w=args.s2w,
        metrics=metrics), device=dev, group=group, mesh=mesh)
    data = SyntheticLM(cfg, ShapeSpec("cli", "train", args.seq, args.batch),
                       n_workers=args.workers, seed=args.seed,
                       device=str(dev), group=tr.worker_group)
    return tr, data


def mesh_steps(tr, state, data, sched, steps: int, grads0=None) -> dict:
    """``steps`` steps from ``state``: each one's loss and host seconds
    (ending with the loss read), step 0's MetricSet as (name, value)
    pairs (None with the metrics off) and the digest of the state after
    it. ``grads0(params, batch_slice)``, where given, takes the place of
    the trainer's loss and gradients at step 0."""
    step_fn = tr.make_step()
    out: dict = {"losses": [], "step_s": []}
    plain = tr._grad_and_loss
    for i in range(steps):
        ts = time.perf_counter()
        tr._grad_and_loss = grads0 if i == 0 and grads0 else plain
        state, aux = step_fn(state, data.batch_at(i), sched(i))
        tr._grad_and_loss = plain
        out["losses"].append(float(aux["loss"]))
        out["step_s"].append(time.perf_counter() - ts)
        if i == 0:
            out["metrics0"] = (list(aux["metrics"].host_floats().items())
                               if "metrics" in aux else None)
            out["digest0"] = digest(state)
    return out


def metric_buckets(tr, mesh) -> list:
    """(residual name, leaf ids, slices) of each NS bucket of a step."""
    return [(f"ns/orth_residual/b{bi}_{b.shape[0]}x{b.shape[1]}",
             list(b.leaf_ids), b.batch)
            for bi, b in enumerate(tr.layer_plan().ns_buckets(mesh=mesh))]


def metrics_deviation(got: list, got_buckets: list, n_stages: int,
                      one: dict) -> tuple[float, list]:
    """(the largest |v - w| / (1 + |w|) of a rank's step-0 MetricSet
    against one process's, what breaks its rules). The names come in one
    process's order; the wire bytes and the participation counts are
    equal, the stage count the run's own; where a model cut splits one
    process's NS bucket by its members' cuts, the split buckets'
    residuals are averaged, slice-weighted, into one process's."""
    want = dict(one["metrics0"])
    got_d = dict(got)

    def order(items) -> list:
        out: list = []
        for k, _ in items:
            k = "ns/" if k.startswith("ns/") else k
            if not out or out[-1] != k:
                out.append(k)
        return out

    bad = []
    if order(got) != order(one["metrics0"]):
        bad.append("the names are not one process's")
    pairs = []
    for k, v in got_d.items():
        if k.startswith("ns/") or k not in want:
            continue
        if k == "wire/n_stages":
            if v != n_stages:
                bad.append(f"{k} {v}, the run's {n_stages}")
        elif k.startswith(("wire/", "part/", "resync/")):
            if v != want[k]:
                bad.append(f"{k} {v} vs {want[k]}")
        else:
            pairs.append((v, want[k]))
    for name, ids, _ in one["buckets"]:
        parts = [(got_d[n], sl) for n, i, sl in got_buckets
                 if set(i) <= set(ids)]
        if not parts:
            bad.append(f"no bucket of the mesh holds {name}'s leaves")
            continue
        pairs.append((sum(v * sl for v, sl in parts)
                      / sum(sl for _, sl in parts), want[name]))
    dev = max(abs(v - w) / (1 + abs(w)) for v, w in pairs)
    return dev, bad


def mesh_train_child(rank: int, tmp: str, mesh_axes: dict,
                     check_off: bool) -> None:
    """One of four ranks of phase 9c or 9d: MESH_STEPS packed two-way
    steps with the MetricSet over the mesh ``mesh_axes`` (with
    ``check_off`` step 0 first without it, from the same state, and the
    step-0 gradients of each worker, gathered whole, written to
    ``tmp/grads<j>.pt`` by its rank at model index 0), then the NS chains
    at its chunk shapes; writes what the parent checks to
    ``tmp/rank<r>.json``."""
    import os
    import traceback
    sys.path.insert(0, str(SRC))
    out: dict = {}
    try:
        import torch
        import torch.distributed as dist
        from repro_torch.core.schedule import warmup_linear_decay
        from repro_torch.dist import sharding
        from repro_torch.launch import train as train_cli
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        world = math.prod(mesh_axes.values())
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(tmp, "store"), world), rank=rank, world_size=world)
        args = train_cli.parse_args(MESH_ARGS)
        mesh = sharding.MeshShape(**mesh_axes)
        tr, data = mesh_trainer(args, dev, True, dist.group.WORLD, mesh)
        sched = warmup_linear_decay(args.radius, args.warmup, args.steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = tr.init(args.seed)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        out["init_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        specs = tr.state_specs()
        shapes = tr.opt.init(None, tr._params_shapes, tr.metas)
        out["held_bytes"] = {k: _nbytes(state[k]) for k in MESH_KEYS}
        out["spec_bytes"] = {k: sharding.spec_bytes(shapes[k], specs[k],
                                                    tr.mesh)
                             for k in MESH_KEYS}
        out["whole_bytes"] = {k: _nbytes(shapes[k]) for k in MESH_KEYS}
        budget = tr.wire_budget()
        if check_off:
            off, _ = mesh_trainer(args, dev, False, dist.group.WORLD, mesh)
            s_off, aux = off.make_step()(state, data.batch_at(0), sched(0))
            out["digest0_off"] = digest(s_off)
            out["metrics_off"] = "metrics" in aux
            del off, s_off, aux
        grads0 = None
        if check_off:
            plan, plain, calls = tr.layer_plan(), tr._grad_and_loss, \
                iter(tr.workers)

            def grads0(params, batch_slice):
                # step 0's loss and gradients, each leaf whole over model
                # on the host for one process's step from the same inputs
                loss, g = plain(params, batch_slice)
                whole = [t if d is None else sharding.gather_shards(
                    t, d, tr.rm.model_group) for t, d in zip(
                        plan.flatten(g), tr.cuts.dims)]
                j = next(calls)
                if tr.rm.model_index == 0:
                    torch.save((float(loss), [t.cpu() for t in whole]),
                               os.path.join(tmp, f"grads{j}.pt"))
                return loss, g

        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        tr.rm.record.clear()
        run = mesh_steps(tr, state, data, sched, MESH_STEPS, grads0)
        torch.cuda.synchronize()
        out["launches"] = all_launches()
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        tags: dict = {}
        for tag, nbytes, sec, staged in tr.rm.record:
            e = tags.setdefault(tag, {"calls": 0, "bytes": 0, "s": 0.0})
            e["calls"] += 1
            e["bytes"] += nbytes
            e["s"] += sec
        for e in tags.values():
            e["calls"] /= MESH_STEPS
            e["bytes"] /= MESH_STEPS
            e["s"] /= MESH_STEPS
        rm = tr.rm
        out.update(
            coords=[rm.pod_index, rm.data_index, rm.model_index],
            worker_ranks=(dist.get_process_group_ranks(tr.worker_group)
                          if tr.worker_group is not None else None),
            workers=[tr.workers.start, tr.workers.stop],
            losses=run["losses"], step_s=run["step_s"],
            metrics0=run["metrics0"], digest0=run["digest0"],
            n_stages=budget.n_stages,
            metric_buckets=metric_buckets(tr, tr.mesh),
            collectives_per_step=tags,
            host_staged_s_per_step=sum(
                s for _, _, s, staged in rm.record if staged) / MESH_STEPS,
            gathered=tr.gathered, broadcast=tr.broadcast_bytes,
            w2s_sizes=[tr.n_local * s for s in budget.w2s_sizes],
            buckets=[[b.batch, *b.shape, list(b.pspec or ())]
                     for b in tr.layer_plan().ns_buckets(mesh=tr.mesh)])
        del run, state
        torch.cuda.empty_cache()
        reset_all_launches()
        out["chains"] = mesh_chunk_chains(tr, dev)
        out["chain_launches"] = all_launches()
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        out["error"] = traceback.format_exc()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def mesh_one_process() -> dict:
    """The one-process run phases 9c and 9d are held against: MESH_ARGS,
    the MetricSet on, MESH_STEPS steps."""
    import torch
    from repro_torch.core.schedule import warmup_linear_decay
    from repro_torch.launch import train as train_cli
    args = train_cli.parse_args(MESH_ARGS)
    tr, data = mesh_trainer(args, torch.device("cuda", 0), True)
    sched = warmup_linear_decay(args.radius, args.warmup, args.steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = mesh_steps(tr, tr.init(args.seed), data, sched, MESH_STEPS)
    torch.cuda.synchronize()
    out = {"losses": run["losses"], "step_s": run["step_s"],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "metrics0": run["metrics0"], "buckets": metric_buckets(tr, None)}
    del run, tr, data
    torch.cuda.empty_cache()
    return out


def spawn_mesh(mesh_axes: dict, check_off: bool, what: str,
               collect=None) -> tuple[list[dict], Any]:
    """Every rank's result of ``mesh_train_child`` over ``mesh_axes``, and
    ``collect(tmp)`` of what they wrote (None without it)."""
    import os
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    world = math.prod(mesh_axes.values())
    try:
        ctx = mp.start_processes(mesh_train_child,
                                 args=(tmp, mesh_axes, check_off),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.time() + MESH_JOIN_S
        done = False
        try:
            while not done and time.time() < deadline:
                done = ctx.join(timeout=5)
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        if not done:
            fail(f"{what}: not done in {MESH_JOIN_S} s")
        got = []
        for r in range(world):
            with open(f"{tmp}/rank{r}.json") as f:
                got.append(json.load(f))
            if "error" in got[r]:
                fail(f"{what}: rank {r} raised:\n{got[r]['error']}")
        collected = collect(tmp) if collect is not None else None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return got, collected


def mesh_one_process_fed(tmp: str) -> dict:
    """One process's step 0 of MESH_ARGS's run, the MetricSet on, fed the
    loss and gradients the mesh's ranks wrote to ``tmp/grads<j>.pt``:
    its MetricSet from the same inputs as theirs."""
    import os
    import torch
    from repro_torch.core.schedule import warmup_linear_decay
    from repro_torch.launch import train as train_cli
    args = train_cli.parse_args(MESH_ARGS)
    dev = torch.device("cuda", 0)
    tr, data = mesh_trainer(args, dev, True)
    sched = warmup_linear_decay(args.radius, args.warmup, args.steps)
    plan, calls = tr.layer_plan(), iter(range(args.workers))

    def fed(params, batch_slice):
        loss, g = torch.load(os.path.join(tmp, f"grads{next(calls)}.pt"))
        return (torch.tensor(loss, device=dev),
                plan.unflatten([t.to(dev) for t in g]))

    run = mesh_steps(tr, tr.init(args.seed), data, sched, 1, fed)
    out = {"metrics0": run["metrics0"], "buckets": metric_buckets(tr, None)}
    del run, tr, data
    torch.cuda.empty_cache()
    return out


def mesh_rank_checks(r: int, res: dict, one: dict, bad: list) -> dict:
    """The checks phases 9c and 9d share on rank ``r``'s result (each
    failure appended to ``bad``); returns its report row."""
    from repro_torch.dist.sharding import TRAIN_TAGS
    one_losses = one["losses"]
    row = {k: res[k] for k in (
        "coords", "workers", "losses", "step_s", "init_s",
        "init_peak_mem_bytes", "held_bytes", "spec_bytes", "whole_bytes",
        "peak_mem_bytes", "collectives_per_step", "host_staged_s_per_step",
        "launches", "chains", "chain_launches")}
    row["steady_step_s"] = sum(res["step_s"][1:]) / (len(res["step_s"]) - 1)
    row["loss_minus_one_process"] = [
        lt - wt for lt, wt in zip(res["losses"], one_losses)]
    dev_m, bad_m = metrics_deviation(res["metrics0"], res["metric_buckets"],
                                     res["n_stages"], one)
    row["metrics0_max_rel_dev"] = dev_m
    row["metrics0_rule_breaks"] = bad_m
    if bad_m or not dev_m <= TOL_MESH_METRIC_OWN:
        bad.append(f"rank {r} step-0 metrics: {dev_m} from one process's "
                   f"own run (limit {TOL_MESH_METRIC_OWN} (1 + |v|)), "
                   f"{bad_m}")
    l0, w0 = res["losses"][0], one_losses[0]
    if not abs(l0 - w0) <= TOL_MESH_LOSS * (1 + abs(w0)):
        bad.append(f"rank {r} step-0 loss {l0} vs one process's {w0}")
    for t, tol in enumerate(TOL_MESH_LOSS_STEP, start=1):
        lt, wt = res["losses"][t], one_losses[t]
        if not abs(lt - wt) <= tol * (1 + abs(wt)):
            bad.append(f"rank {r} step-{t} loss {lt} vs one process's "
                       f"{wt} (limit {tol} (1 + |loss|))")
    if not all(math.isfinite(v) for v in res["losses"]):
        bad.append(f"rank {r} losses {res['losses']}")
    if res["held_bytes"] != res["spec_bytes"]:
        bad.append(f"rank {r} holds {res['held_bytes']}, the specs give "
                   f"{res['spec_bytes']}")
    if res["gathered"] != res["w2s_sizes"] * MESH_STEPS:
        bad.append(f"rank {r} gathered {res['gathered'][:4]}, the "
                   f"budget {res['w2s_sizes']} a step")
    if not set(res["collectives_per_step"]) <= set(TRAIN_TAGS):
        bad.append(f"rank {r} collective tags "
                   f"{sorted(res['collectives_per_step'])}")
    for k in MESH_KERNELS:
        if not res["launches"].get(k):
            bad.append(f"rank {r}: {k} did not launch in the run "
                       f"({res['launches']})")
    for c in res["chains"]:
        if not (c["max_abs_err"] <= TOL_NS_CHAIN
                and c["vs_whole_chain"] <= TOL_NS_CHAIN):
            bad.append(f"rank {r} chain at {c['chunk_shape']} "
                       f"({c['kind']}): {c['max_abs_err']} from plain, "
                       f"{c['vs_whole_chain']} from the whole chain")
    if not res["chain_launches"]["ns_iteration"]:
        bad.append(f"rank {r}: the chunk chains did not launch")
    return row


def mesh_train_phase(smi: str, one: dict) -> dict:
    """9c: nanogpt-124m (MESH_DEPTH layers) trained over a (data=2,
    model=2) mesh of four ranks on cuda:0, the MetricSet on. Fails
    unless every rank's step-0 loss is within TOL_MESH_LOSS (1 + |loss|)
    of one process's run
    (``one``, ``mesh_one_process``), its step-1 and step-2 losses within
    TOL_MESH_LOSS_STEP, and every loss is finite, its step-0 MetricSet is
    within TOL_MESH_METRIC of one process's fed the ranks' step-0
    gradients (``metrics_deviation``, ``mesh_one_process_fed``) and
    within TOL_MESH_METRIC_OWN of one process's own run, its
    state after step 0 is bit-equal to a metrics-off step's, each rank
    holds the specs' bytes of x, w, g_server, g_w and m_w and its init's
    peak stays below the whole state's bytes, its gathers moved its
    workers' budget bytes, the NS kernels and the wire kernels launched
    in the run, every collective of the mesh carried a training tag, and
    each bucket's chain at a rank's chunk shape is within TOL_NS_CHAIN of
    its plain version and of the whole chain. Prints each rank's bytes at
    rest, peak, steady step, collectives by tag (bytes and seconds a
    step), host-staged seconds and the MetricSet's deviations."""
    t_phase = time.perf_counter()
    got, fed = spawn_mesh(MESH_TRAIN, True, "mesh training",
                          mesh_one_process_fed)
    report = {"phase": "9c nanogpt-124m x 4 trained over (data=2, "
                       "model=2), "
                       "four ranks on cuda:0 over gloo, the MetricSet on",
              "card": smi, "mesh": MESH_TRAIN, "args": MESH_ARGS,
              "one_process": {k: one[k] for k in (
                  "losses", "step_s", "peak_mem_bytes")},
              "ranks": []}
    bad = []
    m = MESH_TRAIN["model"]
    for r, res in enumerate(got):
        row = mesh_rank_checks(r, res, one, bad)
        report["ranks"].append(row)
        if res["coords"] != [0, r // m, r % m]:
            bad.append(f"rank {r} sits at {res['coords']}")
        # the gate: one process's MetricSet from the ranks' own step-0
        # gradients (its own run's gradients part from theirs in bf16's
        # last bits, which moves TopK's picks: reported above)
        dev_m, bad_m = metrics_deviation(res["metrics0"],
                                         res["metric_buckets"],
                                         res["n_stages"], fed)
        row["metrics0_fed_max_rel_dev"] = dev_m
        if bad_m or not dev_m <= TOL_MESH_METRIC:
            bad.append(f"rank {r} step-0 metrics: {dev_m} from one "
                       "process's fed the same gradients (limit "
                       f"{TOL_MESH_METRIC} (1 + |v|)), {bad_m}")
        if res["digest0"] != res["digest0_off"] or res["metrics_off"]:
            bad.append(f"rank {r}: the state after step 0 with the "
                       "metrics on is not the metrics-off step's")
        if not res["init_peak_mem_bytes"] < sum(res["whole_bytes"].values()):
            bad.append(f"rank {r} init peaked at "
                       f"{res['init_peak_mem_bytes']} B, the whole state "
                       f"is {sum(res['whole_bytes'].values())} B")
        if any(res["held_bytes"][k] >= res["whole_bytes"][k]
               for k in ("x", "w", "g_server")):
            bad.append(f"rank {r} holds {res['held_bytes']} whole")
        tags = set(res["collectives_per_step"])
        if not {"activation", "activation_grad", "logits", "compressor_in",
                "gram", "ns_rows", "norms"} <= tags:
            bad.append(f"rank {r} collective tags {sorted(tags)}")
        kinds = {c["kind"] for c in res["chains"]}
        if kinds != {"columns", "rows"}:
            bad.append(f"rank {r} chains {kinds}: expected a column cut and "
                       "a row cut")
    report["wall_s"] = time.perf_counter() - t_phase
    report["timing_note"] = ("four ranks sharing one card: collectives "
                             "through pinned host memory and gloo, not a "
                             "link")
    emit(report)
    if bad:
        fail("mesh training: " + "; ".join(bad))
    return report


def pod_train_phase(smi: str, one: dict) -> dict:
    """9d: nanogpt-124m trained over a (pod=2, data=2, model=1) mesh of
    four ranks on cuda:0, the MetricSet on: a worker a pod, a row a rank.
    Fails unless every rank sits at the reference's row-major
    coordinates, owns its pod's worker and gathers the wire over the
    ranks of its (data, model) index, its losses are within
    TOL_MESH_LOSS and TOL_MESH_LOSS_STEP (1 + |loss|) of one process's
    (``one``) and finite, its step-0 MetricSet is within
    TOL_MESH_METRIC_OWN (1 + |v|) of one process's, it holds the specs'
    bytes, its gathers moved the
    budget's bytes, every collective carried a training tag and the row
    gradients were summed over data (``row_grad``), all seven kernels
    launched, and each NS bucket's chain at the rank's (pod, data) rows
    (pod-major) is within TOL_NS_CHAIN of its plain version and of the
    whole chain. Prints what 9c prints."""
    from repro_torch.kernels.ops import lead_rows
    t_phase = time.perf_counter()
    got, _ = spawn_mesh(MESH_POD, False, "pod mesh training")
    report = {"phase": "9d nanogpt-124m x 4 trained over (pod=2, data=2, "
                       "model=1), four ranks on cuda:0 over gloo, the "
                       "MetricSet on",
              "card": smi, "mesh": MESH_POD, "args": MESH_ARGS,
              "one_process": {k: one[k] for k in (
                  "losses", "step_s", "peak_mem_bytes")},
              "ranks": []}
    bad = []
    p, d, m = (MESH_POD[a] for a in ("pod", "data", "model"))
    sizes = dict(MESH_POD)
    for r, res in enumerate(got):
        report["ranks"].append(mesh_rank_checks(r, res, one, bad))
        coords = [r // (d * m), (r // m) % d, r % m]
        if res["coords"] != coords:
            bad.append(f"rank {r} sits at {res['coords']}, not {coords}")
        if res["workers"] != [coords[0], coords[0] + 1]:
            bad.append(f"rank {r} owns workers {res['workers']}")
        if res["worker_ranks"] != [r % (d * m) + k * d * m
                                   for k in range(p)]:
            bad.append(f"rank {r} gathers the wire over "
                       f"{res['worker_ranks']}")
        if "row_grad" not in res["collectives_per_step"]:
            bad.append(f"rank {r}: no row gradient sum over data")
        for c in res["chains"]:
            lead = c["spec"][0] if c["spec"] else None
            axes = [] if lead is None else [lead] if isinstance(lead, str) \
                else lead
            n, idx = 1, 0
            for a in axes:
                n, idx = n * sizes[a], idx * sizes[a] + coords[
                    ("pod", "data", "model").index(a)]
            rows = lead_rows(c["bucket"][0], n, idx)
            want = None if rows is None else [rows.start, rows.stop]
            if c["kind"] != "rows" or c["rows"] != want or axes != [
                    "pod", "data"]:
                bad.append(f"rank {r} chain of {c['bucket']} ({c['spec']})"
                           f" ran rows {c['rows']}, the lead gives {want}")
    report["wall_s"] = time.perf_counter() - t_phase
    report["timing_note"] = ("four ranks sharing one card: collectives "
                             "through pinned host memory and gloo, not a "
                             "link")
    emit(report)
    if bad:
        fail("pod mesh training: " + "; ".join(bad))
    return report


def ns_library(x):
    """One NS iteration in cuBLAS f32 (TF32 off): ``bmm`` + 2
    ``baddbmm``."""
    import torch
    from repro_torch.kernels.ref import NS_COEFFS
    a_, b_, c_ = NS_COEFFS
    g = torch.bmm(x, x.mT)
    return torch.baddbmm(x, torch.baddbmm(g, g, g, beta=b_, alpha=c_), x,
                         beta=a_)


def ns_flop(x, executed: bool) -> int:
    """FLOP one NS iteration needs over a ``[B, m, n]`` stack: the gram
    XX^T and the poly's A^2 are symmetric, so each needs only its
    m(m+1)/2 upper dot products (lengths n and m); the update PX is a
    full GEMM. ``executed``: what the kernels run, the T(T+1)/2 upper
    128 x 128 tiles of the gram and the poly in full, diagonal tiles
    included."""
    from repro_torch.kernels.newton_schulz import TILE
    bsz, m, n = x.shape
    t = -(-m // TILE)
    upper = t * (t + 1) * TILE ** 2 if executed else m * (m + 1)
    return bsz * (upper * n + upper * m + 2 * m * m * n)


def ns_kernel_rows(dev, gen) -> list[dict]:
    """Phase 3a: the NS kernels against their plain versions (and the
    symmetric kernel's exact symmetry), then the rows of both kernels:
    times of kernel, plain version and cuBLAS over one NS iteration of
    both buckets (CUDA events), bounds and rates. Everything it
    allocates dies with it."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.newton_schulz import (fused_matmul,
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


# ------------------------------------------------------------ phase 10
# the dense family beside nanogpt-124m: RMSNorm, RoPE, SwiGLU, GQA, QKV
# bias, sliding windows and untied unembeddings. Reduced, card vs CPU,
# two-way; then qwen2.5-3b at full width (d_model 2048, 16 heads over 2
# KV heads of 128, d_ff 11008, vocab 151,936) cut to QWEN_DEPTH of its 36
# layers, so that its EF21-Muon state and two workers fit one card; then
# one loss-and-gradient pass of all 36 layers
DENSE_ARCHS = ("qwen2.5-3b", "granite-3-2b", "starcoder2-15b",
               "mistral-large-123b")
# seq 96 > starcoder2's reduced window of 64
DENSE_SMALL_ARGS = ["--reduced", "--steps", "3", "--seq", "96", "--batch",
                    "4", "--workers", "2", "--w2s", "top10+natural",
                    "--s2w", "natural", "--log-every", "1"]
QWEN = "qwen2.5-3b"
QWEN_DEPTH = 8
QWEN_ARGS = [QWEN if a == "nanogpt-124m" else a for a in SLICE_ARGS]
QWEN_TWO_WAY_ARGS = [QWEN if a == "nanogpt-124m" else a
                     for a in TWO_WAY_ARGS]
# the NS buckets [B, m, n] of qwen2.5-3b at QWEN_DEPTH layers: wk and wv
# transposed, wq and wo, w_down transposed with w_gate and w_up
QWEN_BUCKETS = ((16, 256, 2048), (16, 2048, 2048), (24, 2048, 11008))
# the full 36-layer pass: one sequence of 1024 tokens
QWEN_FULL_SEQ = 1024


def ns_iterations(tr, steps: int = STEPS) -> int:
    """The LMO's ``ns_iteration`` calls over ``steps`` steps of ``tr``'s
    run: one a bucket and NS step, times the chunks a bucket's workspace
    splits it into (``kernels.ops.ns_batch_chunk``)."""
    from repro_torch.kernels.newton_schulz import TILE
    from repro_torch.kernels.ops import ns_batch_chunk
    calls = 0
    for b in tr.layer_plan().ns_buckets():
        bsz, m = sum(b.counts), -(-min(b.shape) // TILE) * TILE
        calls += -(-bsz // ns_batch_chunk(bsz, m))
    return steps * NS_STEPS * calls


def dense_small_runs() -> list[float]:
    """The four reduced dense archs, 3 two-way steps each, on the card
    against the same runs on the CPU (plain versions)."""
    from repro_torch.launch import train as train_cli
    gaps = []
    for arch in DENSE_ARCHS:
        argv = ["--arch", arch] + DENSE_SMALL_ARGS
        on_card = train_cli.main(argv + ["--device", "cuda"])
        on_cpu = train_cli.main(argv + ["--device", "cpu"])
        gap = max(abs(a - b) for a, b in zip(on_card["losses"],
                                             on_cpu["losses"]))
        emit({"check": f"reduced {arch} losses, w2s top10+natural, s2w "
              "natural, cuda vs cpu", "losses": on_card["losses"],
              "max_abs_diff": gap, "tol": TOL_SLICE_LOSS})
        if len(on_card["losses"]) != 3 or not gap <= TOL_SLICE_LOSS:
            fail(f"reduced {arch} on the card drifts from the CPU run: "
                 f"{gap}")
        gaps.append(gap)
    return gaps


def ns_bucket_rows(dev, gen, buckets=None, tag: str = "qwen",
                   reps: int = 5) -> list[dict]:
    """The NS kernels at an arch's bucket shapes (default qwen's three):
    one iteration against the plain version, the largest bucket's first
    slice also against float64; each timed beside cuBLAS f32 and its
    3xTF32 bound, with the iteration's three launches apart, ``reps``
    calls each."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.newton_schulz import (fused_matmul,
                                                   ns_iteration, syrk_upper)
    a_, b_, c_ = ref.NS_COEFFS
    buckets = QWEN_BUCKETS if buckets is None else buckets
    rows = []
    for shape in buckets:
        x = torch.randn(shape, device=dev, generator=gen)
        x = x / x.flatten(1).norm(dim=1)[:, None, None]
        err = check(f"ns_iteration{list(shape)} ({tag})", ns_iteration(x),
                    ref.ns_iteration_batched_ref(x), TOL_ONE_PASS)
        if shape == max(buckets, key=math.prod):
            xd = x[:1].double()
            g = xd @ xd.mT
            want = a_ * xd + (b_ * g + c_ * (g @ g)) @ xd
            check(f"ns_iteration{[1, *shape[1:]]} ({tag}) vs float64",
                  ns_iteration(x[:1]), want, TOL_ONE_PASS)
            emit({"cublas_f32_ns_iteration_vs_float64": [1, *shape[1:]],
                  "rel_err": ((ns_library(x[:1]) - want).abs().max()
                              / want.abs().max()).item()})
            del xd, g, want
        g = syrk_upper(x)
        p = syrk_upper(g, g, alpha=b_, beta=c_)
        row = {"shape": list(shape), "max_abs_err": err,
               "ms": time_ms(lambda: ns_iteration(x), reps=reps, warmup=1),
               "plain_ms": time_ms(lambda: ref.ns_iteration_batched_ref(x),
                                   reps=reps, warmup=1),
               "library_ms": time_ms(lambda: ns_library(x), reps=5,
                                     warmup=1),
               "gram_ms": time_ms(lambda: syrk_upper(x), reps=reps, warmup=1),
               "poly_ms": time_ms(lambda: syrk_upper(g, g, alpha=b_,
                                                     beta=c_),
                                  reps=reps, warmup=1),
               "update_ms": time_ms(lambda: fused_matmul(
                   p, x, x, alpha=a_, beta=1.0), reps=reps, warmup=1),
               "update_library_ms": time_ms(lambda: torch.baddbmm(
                   x, p, x, beta=a_), reps=reps, warmup=1)}
        needed = ns_flop(x, False)
        row["bound_ms"], row["bound_by"] = bound_ms(
            needed, 2 * 4 * x.numel(), rate=NS_FLOPS)
        row["flop_needed"] = needed
        row["flop_executed"] = ns_flop(x, True)
        row["effective_tflop_s"] = needed / row["ms"] / 1e9
        row["fraction_of_bound"] = row["bound_ms"] / row["ms"]
        emit({f"{tag}_ns_bucket": row})
        rows.append(row)
        del x, g, p
        torch.cuda.empty_cache()
    return rows


def qwen_wire_checks(dev, gen, plans: dict) -> int:
    """The wire kernels at the row shapes qwen's packed w2s wire gives
    them (2 workers), bit for bit against their plain versions: the
    narrow encode and decode of the attention leaves' TopK indices (u24,
    every index of the domain reachable), and for each Natural leaf of
    top10+natural the encode, the sign pack, the decode and the bits
    epilogue of ``unpack_bits``. Returns the checks made."""
    import torch
    from repro_torch.kernels import bitpack as bp
    from repro_torch.kernels import ref
    from repro_torch.kernels.natural_pack import natural_encode
    n = 0
    narrow, _ = wire_shapes(plans["top10"])
    for rows, k, width, domain in sorted(set(narrow)):
        idx = torch.randint(0, domain, (rows, k), device=dev, generator=gen,
                            dtype=torch.int32)
        idx[0, 0], idx[-1, -1] = domain - 1, 0
        enc = bp.narrow_encode(idx, width)
        check_equal(f"qwen narrow_encode [{rows}, {k}] u{8 * width}", enc,
                    bp.narrow_encode_ref(idx, width))
        check_equal(f"qwen narrow_decode [{rows}, {width * k}]",
                    bp.narrow_decode(enc, width),
                    bp.narrow_decode_ref(enc, width))
        n += 2
    _, natural = wire_shapes(plans["top10+natural"])
    for rows, k in sorted(set(natural)):
        vals = (torch.randn(rows, k, device=dev, generator=gen)
                * 1e-3).to(torch.bfloat16)
        codes, signs01 = natural_encode(vals)
        signs = bp.pack_bits(signs01)
        natural_plain_check(f"qwen Natural [{rows}, {k}]", vals, codes,
                            signs)
        check_equal(f"qwen unpack_bits [{rows}, {signs.shape[-1]}]",
                    bp.unpack_bits(signs)[..., :k],
                    bp.unpack_bits_ref(signs)[..., :k])
        del vals, codes, signs01, signs
        n += 4
    torch.cuda.synchronize()
    return n


def qwen_f32_checks(dev, gen, plan) -> int:
    """The f32 kernels at the shapes qwen's EF21 rounds give them (2
    workers, every leaf of ``plan``, one leaf at a time), bit for bit
    against their plain versions, NaNs of both signs, +-inf, +-0 and
    subnormals among the values: ``add_f32`` as the workers' estimate +
    delta (``[2, *shape]``, both operand orders) and as one delta for
    both workers' W_j, ``fold_f32`` as the server's fold, ``to_bf16`` as
    the workers' differences (lossy leaves) and the server's. Returns the
    checks made."""
    import numpy as np
    import torch
    from repro_torch.kernels import natural_pack as nat
    from repro_torch.kernels import ref
    special = torch.from_numpy(np.array(
        NAN_BITS + (0x7F800000, 0xFF800000, 0, 0x80000000, 0x3F800000, 1,
                    0x80000001, 0x00018000, 0x3F808000, 0x3F818000,
                    0x7F7FFFFF), np.uint32).view(np.float32)).to(dev)

    def leaf(shape, flip=False):
        t = torch.randn(shape, device=dev, generator=gen)
        t.view(-1)[:special.numel()] = special.flip(0) if flip else special
        return t

    def bits(t):
        return t.view(torch.int32 if t.dtype == torch.float32
                      else torch.int16)

    n = 0
    for lp in plan.leaves:
        tag = f"(qwen) {[2, *lp.shape]}"
        est, delta = leaf((2,) + lp.shape), leaf((2,) + lp.shape, flip=True)
        check_equal(f"add_f32 {tag}", bits(nat.add_f32(est, delta)),
                    bits(ref.add_f32_ref(est, delta)))
        check_equal(f"add_f32 delta first {tag}",
                    bits(nat.add_f32(delta, est)),
                    bits(ref.add_f32_ref(delta, est)))
        check_equal(f"add_f32 one delta for both W_j {tag}",
                    bits(nat.add_f32(delta[0], est)),
                    bits(ref.add_f32_ref(delta[0], est)))
        if not getattr(lp.w2s, "lossless_wire", False):
            check_equal(f"to_bf16 {tag}", bits(nat.to_bf16(delta)),
                        bits(ref.to_bf16_ref(delta)))
            n += 1
        check_equal(f"to_bf16 (qwen) {list(lp.shape)}",
                    bits(nat.to_bf16(delta[1])),
                    bits(ref.to_bf16_ref(delta[1])))
        del est
        g = leaf(lp.shape)
        check_equal(f"fold_f32 {tag}", bits(nat.fold_f32(g, delta, 2)),
                    bits(ref.fold_f32_ref(g, delta, 2)))
        del g, delta
        torch.cuda.empty_cache()
        n += 5
    return n


def qwen_full_depth_pass(dev) -> dict:
    """One loss-and-gradient pass of qwen2.5-3b with all 36 layers (3.09
    B parameters in bf16, drawn on the card from a seed), on one
    sequence of QWEN_FULL_SEQ tokens: a finite loss near ln(vocab),
    finite gradients of every leaf; time (the second pass) and peak."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.dist.layerwise import tree_leaves
    from repro_torch.models.api import build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config(QWEN)
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(params))
    batch = SyntheticLM(cfg, ShapeSpec("full", "train", QWEN_FULL_SEQ, 1),
                        seed=0, device=str(dev)).batch_at(0)
    batch = {k: v[0] for k, v in batch.items()}
    tr = Trainer(model, TrainerConfig(), device=dev)
    times, losses = [], []
    for _ in range(2):
        grads = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = tr._grad_and_loss(params, batch)
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    peak = torch.cuda.max_memory_allocated()
    out = {"phase": "10 qwen2.5-3b, all 36 layers, loss and gradients",
           "n_layers": cfg.n_layers, "params": n_params,
           "seq": QWEN_FULL_SEQ, "batch": 1, "init_s": init_s,
           "losses": losses, "pass_s": times, "peak_mem_bytes": peak,
           "grads_finite": finite}
    emit(out)
    if not all(math.isfinite(v) for v in losses) or not finite:
        fail(f"qwen2.5-3b full depth: loss {losses}, gradients finite "
             f"{finite}")
    if abs(losses[0] - math.log(cfg.vocab)) > 1.0:
        fail(f"qwen2.5-3b full depth: loss {losses[0]} far from ln(vocab) "
             f"{math.log(cfg.vocab):.3f}")
    return out


def dense_zoo_phase(dev, gen) -> dict:
    """Phase 10: the reduced dense archs card vs CPU; the NS kernels at
    qwen's buckets; qwen2.5-3b at QWEN_DEPTH layers for STEPS steps
    unpacked (top10), packed top10 over a one-rank NCCL group (step 0's
    payloads through the wire first, losses against the unpacked run,
    gathers against the budget, every kernel's launches against the
    layouts), packed top10+natural, the wire kernels at its row shapes,
    the server's natural message after one two-way step through the s2w
    wire, and packed two-way top10+natural / natural; the f32 kernels at
    its leaves' shapes; then the full 36-layer pass.
    Returns the NS bucket rows and the launches of the qwen runs."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    t_phase = time.perf_counter()
    dense_small_runs()
    torch.cuda.empty_cache()
    ns_rows = ns_bucket_rows(dev, gen)
    qcfg = get_config(QWEN).with_depth(QWEN_DEPTH)

    # unpacked top10, through setup / run_steps (the CLI has no depth flag)
    args = train_cli.parse_args(QWEN_ARGS)
    _, tr, data, sched = train_cli.setup(args, cfg=qcfg)
    iters = ns_iterations(tr)
    want = expected_launches(tr, iters, packed=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    out = train_cli.run_steps(tr, tr.init(args.seed), data, sched, STEPS)
    torch.cuda.synchronize()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(math.prod(lp.shape) for lp in tr.layer_plan().leaves)
    del out["state"], out["aux"], tr, data
    losses = out["losses"]
    emit({"slice": f"{QWEN} x {QWEN_DEPTH} layers", "params": n_params,
          "steps": STEPS, "seq": 1024, "batch": 8, "workers": 2,
          "w2s": "top10", "losses": losses, "step_s": out["step_s"],
          "peak_mem_bytes": peak, "ns_iterations": iters,
          "launches": launches})
    if len(losses) != STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"{QWEN} unpacked: non-finite or missing losses {losses}")
    if abs(losses[0] - math.log(qcfg.vocab)) > 1.0:
        fail(f"{QWEN} unpacked: initial loss {losses[0]} far from "
             f"ln(vocab) {math.log(qcfg.vocab):.3f}")
    if launches != want:
        fail(f"{QWEN} unpacked launches {launches}, the layouts imply "
             f"{want}")
    torch.cuda.empty_cache()

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        wire_round_trip(args, group, cfg=qcfg)
        torch.cuda.empty_cache()
        packed = packed_run(args, group, iters, cfg=qcfg)
        gap = max(abs(a - b) for a, b in zip(packed["losses"], losses))
        # the wire moves the payloads bit for bit, so the two runs' losses
        # must be equal, not only close
        emit({"check": f"{QWEN} packed vs unpacked top10 losses",
              "max_abs_diff": gap, "bit_equal": packed["losses"] == losses,
              "steady_step_s": {"unpacked": out["step_s"][1:],
                                "packed": packed["step_s"][1:]},
              "peak_mem_bytes": {"unpacked": peak,
                                 "packed": packed["peak"]}})
        if packed["losses"] != losses:
            fail(f"{QWEN} packed top10 losses {packed['losses']} are not "
                 f"the unpacked run's {losses}")
        torch.cuda.empty_cache()
        nat_args = train_cli.parse_args(QWEN_ARGS
                                        + ["--w2s", "top10+natural"])
        natural = packed_run(nat_args, group, iters, cfg=qcfg)
        torch.cuda.empty_cache()
        plans = {}
        for w2s in ("top10", "top10+natural"):
            a = train_cli.parse_args(QWEN_ARGS + ["--w2s", w2s])
            plans[w2s] = train_cli.setup(a, cfg=qcfg)[1].layer_plan()
        n_wire = qwen_wire_checks(dev, gen, plans)
        torch.cuda.empty_cache()
        two_args = train_cli.parse_args(QWEN_TWO_WAY_ARGS)
        s2w_tr, s2w_state = s2w_round_trip(
            group, QWEN_TWO_WAY_ARGS, ("natural",), cfg=qcfg)
        del s2w_tr, s2w_state
        torch.cuda.empty_cache()
        two_way = packed_run(two_args, group, iters, cfg=qcfg)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    n_f32 = qwen_f32_checks(dev, gen, plans["top10"])
    full = qwen_full_depth_pass(dev)
    torch.cuda.empty_cache()
    wire = WIRE[QWEN, QWEN_DEPTH]
    res = {"phase": f"10 dense zoo, {QWEN} x {QWEN_DEPTH}",
           "wall_s": time.perf_counter() - t_phase,
           "steady_step_s": {"unpacked_top10": out["step_s"][1:],
                             "packed_top10": packed["step_s"][1:],
                             "packed_top10_natural": natural["step_s"][1:],
                             "packed_two_way": two_way["step_s"][1:]},
           "peak_mem_bytes": {"unpacked_top10": peak,
                              "packed_top10": packed["peak"],
                              "packed_top10_natural": natural["peak"],
                              "packed_two_way": two_way["peak"],
                              "full_36_layers": full["peak_mem_bytes"]},
           "w2s_bytes_per_step": {"top10": 2 * sum(wire["w2s"]["top10"]),
                                  "two_way": 2 * sum(
                                      wire["w2s"]["top10+natural"])},
           "s2w_bytes_per_step": sum(wire["s2w"]["natural"]),
           "wire_kernel_checks": n_wire, "f32_kernel_checks": n_f32}
    emit(res)
    return {"ns_rows": ns_rows, "launches": packed["launches"],
            "two_way_launches": two_way["launches"]}


# ------------------------------------------------------------ phase 11
# serving at full width: qwen2.5-3b (18 of 36 layers) and starcoder2-15b
# (20 of 40 layers, a prompt longer than its 4096 window: the ring cache);
# the Mixtral MoE served at SERVE's depth, trained at MIXTRAL_DEPTH; then
# the reduced serving archs and Mixtral card against CPU. Weights are
# drawn on the card from a seed. Each depth was cut to keep the smoke in
# its time limit (PERF.md §6): phase 11 took 162 s and 11b 75 s on one
# machine with qwen and starcoder2 whole and mixtral at 8 layers.
SERVE = {  # arch: (layers or None for all, batch, prompt, new tokens)
    "qwen2.5-3b": (18, 8, 2048, 128),
    "starcoder2-15b": (20, 2, 4608, 16),
    "mixtral-8x7b": (4, 8, 1024, 32)}
# decode against the full forward (teacher-forced, 3 positions, in f32
# on the served weights): the reference test's bound, |decode - full| <=
# TOL_DECODE (1 + |full|)
TOL_DECODE = 0.05
DECODE_CHECK_STEPS = 3
# the MoE's no-drop capacity factor for that check (capacity dispatch
# drops other tokens at another token count)
NO_DROP_CAPACITY = 16.0
# the reduced serving archs card vs CPU: logits of f32 models in another
# summation order (abs), and the greedy tokens
TOL_SERVE_F32 = 1e-4
# xLSTM's: its mLSTM normaliser max(|q.n|, exp(-m)) amplifies rounding,
# and reduced xlstm's served logits in f32 sit 2.3e-4 from float64 on the
# CPU (tests/test_torch_xlstm.py), so card and CPU are held at 2e-3
SERVE_SMALL_TOL = {"xlstm-1.3b": 2e-3}
# (arch, window, MoE fields replaced): deepseek reduced (4 experts,
# top-2) and its top-8 variant
TOP8 = {"n_experts": 16, "top_k": 8}
SERVE_SMALL = (("granite-3-2b", None, None), ("starcoder2-15b", 6, None),
               ("mixtral-8x7b", None, None),
               ("deepseek-v3-671b", None, None),
               ("deepseek-v3-671b", None, TOP8))
MIXTRAL = "mixtral-8x7b"
MIXTRAL_DEPTH = 1
MIXTRAL_STEPS = 3
# --donate: the step writes the new EF21 state into the old one's
# tensors; undonated, both are alive through the LMO (~55 B a parameter
# on qwen2.5-3b x 8, phase 10) and 1.71 B parameters do not fit the card
MIXTRAL_ARGS = [MIXTRAL if a == "nanogpt-124m" else
                str(MIXTRAL_STEPS) if a == str(STEPS) else a
                for a in SLICE_ARGS] + ["--donate"]
MIXTRAL_TWO_WAY_ARGS = [MIXTRAL if a == "nanogpt-124m" else
                        str(MIXTRAL_STEPS) if a == str(STEPS) else a
                        for a in TWO_WAY_ARGS] + ["--donate"]
# the NS buckets [B, m, n] of mixtral at MIXTRAL_DEPTH layers: the 8
# experts' e_gate and e_up and e_down transposed; wq and wo; wk and wv
# transposed; the router transposed
MIXTRAL_BUCKETS = ((24, 4096, 14336), (2, 4096, 4096), (2, 1024, 4096),
                   (1, 8, 4096))
# the two-way run is added when the one-way packed run's peak plus what
# the s2w leg adds on qwen2.5-3b x 8 in phase 10 (7.42 GB for 927.8 M
# params, 8 B a parameter) stays under this
TWO_WAY_PEAK_LIMIT = 72e9
S2W_BYTES_PER_PARAM = 8


def _full_model(arch: str, layers, dev):
    """The published config (cut to ``layers``), its model and params
    drawn on the card from a seed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config(arch)
    if layers:
        cfg = cfg.with_depth(layers)
    model = build_model(cfg)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    return cfg, model, params


def _nbytes(tree) -> int:
    from repro_torch.dist.layerwise import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def prompt_shape(prompt: dict) -> tuple[int, int]:
    """(batch, prompt length) of a prefill batch: its ``tokens``, or
    Qwen2-VL's ``embeds``."""
    x = prompt["tokens"] if "tokens" in prompt else prompt["embeds"]
    return x.shape[0], x.shape[1]


def decode_host_share(model, params, prompt: dict, new: int,
                      steps: int = 4):
    """``steps`` greedy decode steps after a prefill of ``prompt`` (a
    prefill batch) under ``torch.profiler``: the wall time, the card's
    busy time (its kernels and copies) and the share of the wall the card
    sat idle, which the host's launches of the Python layer loop leave
    it; the launches a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_step import device_busy_ms
    bsz, s = prompt_shape(prompt)
    dev = next(iter(prompt.values())).device
    cache = model.init_cache(bsz, s + new, dev)
    logits, cache = model.prefill(params, prompt, cache)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    logits, cache = model.decode_step(params, {"token": tok, "t": s}, cache)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = model.decode_step(
                params, {"token": tok, "t": s + 1 + i}, cache)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = device_busy_ms(prof.events()) / 1e3
    launches = sum(e.count for e in prof.key_averages() if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    del cache
    return {"profiled_steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
            "device_busy_ms_per_step": 1e3 * busy / steps,
            "host_share": 1.0 - busy / wall,
            "launches_per_step": launches / steps}


def full_logits(model, params, prompt: dict, toks) -> list:
    """The full forward over ``prompt`` followed by ``toks`` [B, n], every
    position at once: the f32 logits at the n positions of ``toks``. A
    Qwen2-VL prompt (``embeds``) continues with the tokens' ``embed`` rows
    at their position on all three M-RoPE channels; a Whisper prompt
    (``frames``) with the tokens after its own, on the same frames."""
    import torch
    from repro_torch.models.common import logits_last
    bsz, s = prompt_shape(prompt)
    n = toks.shape[1]
    with torch.inference_mode():
        if "frames" in prompt:
            h = model.hidden(params, {"frames": prompt["frames"], "tokens":
                                      torch.cat([prompt["tokens"], toks], 1)})
            un = params["unembed"]
        elif not hasattr(model, "_embed_in"):     # the recurrent families
            h = model.hidden(params, {"tokens": torch.cat(
                [prompt["tokens"], toks], 1)})
            un = model._unembed(params)
        else:
            if "embeds" in prompt:
                t = torch.arange(s, s + n, device=toks.device)
                batch = {"embeds": torch.cat([prompt["embeds"],
                                              params["embed"][toks]], 1),
                         "pos": torch.cat([prompt["pos"], t[None, :, None]
                                           .expand(bsz, -1, 3)], 1)}
            else:
                batch = {"tokens": torch.cat([prompt["tokens"], toks], 1)}
            x, pos = model._embed_in(params, batch)
            h, _ = model._run(params, x, pos)
            del x
            un = model._unembed(params)
        out = [logits_last(h[:, s + i], un) for i in range(n)]
        del h
    return out


def decode_vs_full(tag: str, model, params, tokens,
                   n: int = DECODE_CHECK_STEPS, gate: bool = True,
                   prompt: dict | None = None) -> float:
    """Prefill ``tokens[:, :S-n]`` (or ``prompt``, a prefill batch, with
    ``tokens`` [B, n] after it), then ``n`` teacher-forced decode steps
    on the tokens after it; each step's logits against the full
    forward's at the same position (``full_logits``; a recurrent model's
    full forward is its scans over every position). ``gate``: fail
    beyond TOL_DECODE. Returns the largest difference."""
    import torch
    if prompt is None:
        prompt, tokens = {"tokens": tokens[:, :-n]}, tokens[:, -n:]
    bsz, s = prompt_shape(prompt)
    cache = model.init_cache(bsz, s + n, tokens.device)
    _, cache = model.prefill(params, prompt, cache)
    dec = []
    for i in range(n):
        lg, cache = model.decode_step(
            params, {"token": tokens[:, i:i + 1], "t": s + i}, cache)
        dec.append(lg)
    del cache
    full = full_logits(model, params, prompt, tokens)
    worst, excess = 0.0, -1.0
    for a, b in zip(dec, full):
        if not bool(torch.isfinite(a).all()):
            fail(f"{tag}: non-finite decode logits")
        worst = max(worst, (a - b).abs().max().item())
        excess = max(excess, ((a - b).abs() - TOL_DECODE
                              * (1 + b.abs())).max().item())
    emit({"check": f"{tag} decode vs full forward, {n} teacher-forced "
          f"positions", "batch": bsz, "seq": s + n, "max_abs_err": worst,
          "within_tol": excess <= 0,
          "tol": f"{TOL_DECODE} (1 + |full|)" if gate else "reported"})
    if gate and excess > 0:
        fail(f"{tag}: decode logits {worst} from the full forward's")
    return worst


def to_f32_model(cfg, params, dtype: str = "float32"):
    """The model in f32 (or ``dtype``) on the same weights: ``params``
    upcast in place, leaf by leaf (each tensor freed as its copy is
    made)."""
    import dataclasses
    import torch
    from repro_torch.dist.layerwise import leaf_paths, tree_get
    from repro_torch.models.api import build_model
    for p in leaf_paths(params):
        parent = tree_get(params, p[:-1])
        parent[p[-1]] = parent[p[-1]].to(getattr(torch, dtype))
    torch.cuda.empty_cache()
    return build_model(dataclasses.replace(cfg, dtype=dtype))


def decode_unread_bytes(cfg, params) -> int:
    """The weights a decode step leaves unread: an MTP head's (serving
    skips it), Whisper's encoder (prefill runs it once), and the tables
    a step gathers only B rows of: an untied embedding and a learned
    position table."""
    keys = ["mtp", "pos_embed", "enc_blocks", "enc_final_ln_w",
            "enc_final_ln_b"]
    if not cfg.tied_embeddings:
        keys.append("embed")
    return _nbytes({k: params[k] for k in keys if k in params})


# a cache's recurrent states (Griffin's RG-LRU and conv tail, xLSTM's
# mLSTM and sLSTM states): read and written whole by every decode step
RECURRENT_STATES = ("rec", "m_blocks", "s_blocks")


def decode_cache_bytes(spec, kv_len: int, cap: int) -> int:
    """Bytes of the cache one decode step moves: the self-attention K/V
    (or MLA's latents) read up to ``kv_len`` of their ``cap`` slots,
    Whisper's cross K/V read whole, the recurrent states read and
    written whole."""
    from repro_torch.dist.layerwise import leaf_paths, tree_get
    total = 0
    for path in leaf_paths(spec):
        t = tree_get(spec, path)
        n = t.numel() * t.element_size()
        if any(k in RECURRENT_STATES for k in path):
            total += 2 * n
        elif path[-1] in ("xk", "xv"):
            total += n
        else:
            total += n * kv_len // cap
    return total


def serve_full(arch: str, dev, gen, phase: int = 11) -> dict:
    """``arch`` at full width (SERVE's depth, batch, prompt and new
    tokens; ``make_batch``'s prompt: tokens, Qwen2-VL's patch embeddings
    and M-RoPE ids, Whisper's frames and tokens), greedy: two
    ``Server.generate`` runs give the same tokens (in range); prefill s,
    decode ms a token against its bytes bound (the weights a step reads,
    ``decode_unread_bytes`` left out; the cache, ``decode_cache_bytes``
    at the last step's length; the f32 cast of the unembedding
    ``logits_last`` makes), peak; launches of the port's
    kernels (none); the host's share of a decode step; decode against
    the full forward."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist.layerwise import tree_leaves
    from repro_torch.models.api import make_batch
    from repro_torch.train.serve import Server
    layers, bsz, prompt_len, new = SERVE[arch]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, params = _full_model(arch, layers, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = _nbytes(params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    spec = model.cache_spec(bsz, prompt_len + new)
    total = prompt_len + new
    cap = min(cfg.window or total, total)
    cache_bytes = _nbytes(spec)
    unread = decode_unread_bytes(cfg, params)
    prompt = make_batch(cfg, ShapeSpec("p", "prefill", prompt_len, bsz),
                        gen, device=dev)
    server = Server(model)
    runs = []
    reset_all_launches()
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        toks = server.generate(params, prompt, new)
        runs.append((toks, dict(server.timings),
                     torch.cuda.max_memory_allocated()))
    launches = all_launches()
    (t1, _, peak1), (t2, tm, peak) = runs
    same = torch.equal(t1, t2)
    in_range = bool(((t2 >= 0) & (t2 < cfg.vocab)).all())
    un = cfg.vocab * cfg.d_model
    step_bytes = (weights - unread
                  + decode_cache_bytes(spec, min(total, cap), cap) + 6 * un)
    if cfg.family == "ssm":     # no attention, so no capacity
        cap = None
    bound, by = bound_ms(0, step_bytes)
    decode_ms = 1e3 * tm["decode_s"] / new
    host = decode_host_share(model, params, prompt, new)
    out = {"phase": f"{phase} serve {arch}", "n_layers": cfg.n_layers,
           "params": n_params, "weight_bytes": weights, "init_s": init_s,
           "batch": bsz, "prompt": prompt_len, "new": new,
           "cache_capacity": cap, "cache_bytes": cache_bytes,
           "prefill_s": tm["prefill_s"], "decode_ms_per_token": decode_ms,
           "first_run": {"prefill_s": runs[0][1]["prefill_s"],
                         "decode_ms_per_token":
                             1e3 * runs[0][1]["decode_s"] / new},
           "tok_s": bsz * new / (tm["prefill_s"] + tm["decode_s"]),
           "decode_bound_bytes": step_bytes, "decode_bound_ms": bound,
           "decode_bound_by": by,
           "decode_fraction_of_bound": bound / decode_ms,
           "peak_mem_bytes": peak, "first_run_peak_mem_bytes": peak1,
           "greedy_runs_equal": same, "kernel_launches": launches,
           "decode_profile": host, "tokens_row0": t2[0, :16].tolist()}
    emit(out)
    if not same or not in_range or t2.shape != (bsz, new):
        fail(f"{arch}: greedy generation not deterministic or out of range")
    if any(launches.values()):
        fail(f"{arch}: serving launched the port's kernels {launches}")
    tokens = t2.cpu()
    del server, runs, t1, t2, toks
    torch.cuda.empty_cache()
    return {"out": out, "cfg": cfg, "model": model, "params": params,
            "prompt": prompt.get("tokens"), "batch": prompt,
            "tokens": tokens}


def forced_logits(srv, params, prompt: dict, toks, steps: int,
                  max_len: int):
    """Prefill's f32 logits and ``steps`` decode steps' fed ``toks`` [B,
    n] (teacher-forced) through ``srv.prefill``/``decode`` with a cache of
    ``max_len``: ``[1 + steps, rows, V]`` on the CPU, and the bytes of
    the cache the server held."""
    import torch
    _, s = prompt_shape(prompt)
    logits, state = srv.prefill(params, prompt, max_len)
    out = [logits.cpu()]
    rows = state["rows"]
    for i in range(steps):
        out.append(srv.decode(state, toks[rows, i:i + 1].to(logits.device),
                              s + i).cpu())
    cache_bytes = _nbytes(state["cache"])
    del state
    return torch.stack(out), cache_bytes


def serve_phase(dev, gen) -> dict:
    """11a-c serving: qwen2.5-3b, starcoder2-15b and mixtral at full width
    and SERVE's depth. Decode against the full forward is checked in
    f32 (the reference test's dtype; the same weights upcast, starcoder2 on one
    row to fit the card), starcoder2's over a ring of its 4096-token window,
    mixtral's at a no-drop capacity; in bf16, as served, it is reported (bf16
    rounding through the stack, and in the MoE a router near-tie that flips an
    expert, move logits by more)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.api import build_model, make_batch
    from repro_torch.train.serve import Server
    res = {}
    q = serve_full("qwen2.5-3b", dev, gen)
    tokens = q["prompt"][:2]
    q["out"]["decode_vs_full_bf16"] = decode_vs_full(
        "qwen2.5-3b bf16", q["model"], q["params"], tokens, gate=False)
    m32 = to_f32_model(q["cfg"], q["params"])
    q["out"]["decode_vs_full"] = decode_vs_full(
        "qwen2.5-3b f32", m32, q["params"], tokens)
    res["qwen2.5-3b"] = q["out"]
    del q, m32, tokens
    torch.cuda.empty_cache()

    s = serve_full("starcoder2-15b", dev, gen)
    if s["out"]["cache_capacity"] != 4096:
        fail(f"starcoder2-15b cache capacity {s['out']['cache_capacity']}")
    _, bsz, prompt_len, _ = SERVE["starcoder2-15b"]
    longer = make_batch(s["cfg"], ShapeSpec(
        "p", "prefill", prompt_len + DECODE_CHECK_STEPS, bsz), gen,
        device=dev)["tokens"]
    s["out"]["decode_vs_full_bf16"] = decode_vs_full(
        "starcoder2-15b (ring) bf16", s["model"], s["params"], longer,
        gate=False)
    m32 = to_f32_model(s["cfg"], s["params"])
    s["out"]["decode_vs_full"] = decode_vs_full(
        "starcoder2-15b (ring) f32", m32, s["params"], longer[:1])
    res["starcoder2-15b"] = s["out"]
    del s, longer, m32
    torch.cuda.empty_cache()

    m = serve_full(MIXTRAL, dev, gen)
    # what phase 11b's two ranks are held against: the prompt, the greedy
    # tokens, prefill's and 3 teacher-forced decode steps' logits
    res["sharded_ref"] = {
        "prompt": m["prompt"].cpu(), "tokens": m["tokens"],
        "peak_mem_bytes": m["out"]["peak_mem_bytes"],
        "logits": forced_logits(
            Server(m["model"]), m["params"], m["batch"], m["tokens"],
            DECODE_CHECK_STEPS, sum(SERVE[MIXTRAL][2:]))[0]}
    cfg = dataclasses.replace(m["cfg"], moe=dataclasses.replace(
        m["cfg"].moe, capacity_factor=NO_DROP_CAPACITY))
    tokens = m["prompt"][:2]
    tag = f"{MIXTRAL} x {cfg.n_layers} (capacity {NO_DROP_CAPACITY})"
    m["out"]["decode_vs_full_bf16"] = decode_vs_full(
        f"{tag} bf16", build_model(cfg), m["params"], tokens, gate=False)
    m32 = to_f32_model(cfg, m["params"])
    m["out"]["decode_vs_full"] = decode_vs_full(f"{tag} f32", m32,
                                                m["params"], tokens)
    # phase 11b's gate: the same forced steps in f32 at the no-drop
    # capacity, on SHARDED_F32_ROWS rows
    res["sharded_ref"]["logits_f32"] = forced_logits(
        Server(m32), m["params"], {"tokens": m["prompt"][:SHARDED_F32_ROWS]},
        m["tokens"][:SHARDED_F32_ROWS], DECODE_CHECK_STEPS,
        sum(SERVE[MIXTRAL][2:]))[0]
    res[MIXTRAL] = m["out"]
    del m, m32, tokens
    torch.cuda.empty_cache()
    return res


def train_and_pack(dev, argv, cfg, tag: str, steps: int, n_params: int,
                   two_way_argv: list | None = None) -> dict:
    """``cfg``'s run of ``argv``: unpacked through ``setup`` /
    ``run_steps`` (the first loss in ``first_loss_band``, launches as the
    layouts imply), then packed over a one-rank NCCL group (gathers and
    broadcasts against the budget and WIRE, launches); the packed losses
    bit-equal to the unpacked run's. ``two_way_argv``: then that run packed too, where
    the packed run's peak plus what the s2w leg adds
    (S2W_BYTES_PER_PARAM) stays under TWO_WAY_PEAK_LIMIT."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train as train_cli
    args = train_cli.parse_args(argv)
    _, tr, data, sched = train_cli.setup(args, cfg=cfg)
    iters = ns_iterations(tr, steps)
    want = expected_launches(tr, iters, packed=False, steps=steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    out = train_cli.run_steps(tr, tr.init(args.seed), data, sched, steps)
    torch.cuda.synchronize()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    del out["state"], out["aux"], tr, data
    losses = out["losses"]
    centre, half = first_loss_band(cfg)
    emit({"slice": tag, "params": n_params, "steps": steps,
          "seq": args.seq, "batch": args.batch, "workers": args.workers,
          "w2s": args.w2s, "s2w": args.s2w, "losses": losses,
          "first_loss_band": [centre, half], "step_s": out["step_s"],
          "peak_mem_bytes": peak, "ns_iterations": iters,
          "launches": launches})
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        fail(f"{tag} unpacked: non-finite or missing losses {losses}")
    if abs(losses[0] - centre) > half:
        fail(f"{tag} unpacked: initial loss {losses[0]} more than {half} "
             f"from {centre:.3f}")
    if launches != want:
        fail(f"{tag} unpacked launches {launches}, the layouts imply {want}")
    torch.cuda.empty_cache()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    # NCCL makes its communicator, and takes its buffers outside PyTorch's
    # allocator, at the first collective: make it now, before the run
    # fills the card (at recurrentgemma's cut, 61.9 GB, a first all-gather
    # inside the step found no memory left for them)
    dist.all_reduce(torch.zeros(1, device=dev))
    two_way = None
    try:
        group = dist.group.WORLD
        packed = packed_run(args, group, iters, cfg=cfg, steps=steps)
        gap = max(abs(a - b) for a, b in zip(packed["losses"], losses))
        emit({"check": f"{tag} packed vs unpacked {args.w2s} / s2w "
              f"{args.s2w} losses", "bit_equal": packed["losses"] == losses,
              "max_abs_diff": gap,
              "tol": 0.0,
              "steady_step_s": {"unpacked": out["step_s"][1:],
                                "packed": packed["step_s"][1:]},
              "peak_mem_bytes": {"unpacked": peak,
                                 "packed": packed["peak"]}})
        if packed["losses"] != losses:
            fail(f"{tag} packed losses {packed['losses']} drift from the "
                 f"unpacked run's {losses}")
        torch.cuda.empty_cache()
        if two_way_argv is not None:
            predicted = packed["peak"] + S2W_BYTES_PER_PARAM * n_params
            emit({f"{tag} two_way_predicted_peak_bytes": predicted,
                  "limit": TWO_WAY_PEAK_LIMIT,
                  "run": predicted < TWO_WAY_PEAK_LIMIT})
            if predicted < TWO_WAY_PEAK_LIMIT:
                two_way = packed_run(train_cli.parse_args(two_way_argv),
                                     group, iters, cfg=cfg, steps=steps)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"launches": packed["launches"],
            "two_way_launches": two_way["launches"] if two_way else None,
            "unpacked": {"losses": losses, "step_s": out["step_s"],
                         "peak": peak},
            "packed": {k: packed[k] for k in ("losses", "step_s", "peak")},
            "two_way": {k: two_way[k] for k in ("losses", "step_s", "peak")}
            if two_way else None}


def plan_buckets(argv, cfg, want: tuple, tag: str) -> int:
    """The NS buckets of ``cfg``'s run of ``argv`` against ``want``; its
    parameter count."""
    from repro_torch.launch import train as train_cli
    _, tr, _, _ = train_cli.setup(train_cli.parse_args(argv), cfg=cfg)
    formed = [(sum(b.counts),) + tuple(b.shape)
              for b in tr.layer_plan().ns_buckets()]
    emit({f"{tag}_ns_buckets": formed})
    if sorted(formed) != sorted(want):
        fail(f"{tag} NS buckets {formed}, expected {want}")
    return sum(math.prod(lp.shape) for lp in tr.layer_plan().leaves)


def mixtral_train_phase(dev, gen) -> dict:
    """11c training: the NS kernels at mixtral's buckets (one iteration
    vs plain, the largest vs float64, timed vs cuBLAS f32 and the bound);
    mixtral at full width and MIXTRAL_DEPTH layers, 2 workers, seq 1024,
    batch 8, MIXTRAL_STEPS donated steps through ``train_and_pack``:
    unpacked top10, packed top10 (losses bit-equal), then packed two-way
    top10+natural / natural where its predicted peak stays under
    TWO_WAY_PEAK_LIMIT."""
    import torch
    from repro_torch.configs import get_config
    mcfg = get_config(MIXTRAL).with_depth(MIXTRAL_DEPTH)
    n_params = plan_buckets(MIXTRAL_ARGS, mcfg, MIXTRAL_BUCKETS, "mixtral")
    ns_rows = ns_bucket_rows(dev, gen, MIXTRAL_BUCKETS, "mixtral", reps=2)
    torch.cuda.empty_cache()
    out = train_and_pack(dev, MIXTRAL_ARGS, mcfg,
                         f"{MIXTRAL} x {MIXTRAL_DEPTH} layers",
                         MIXTRAL_STEPS, n_params,
                         two_way_argv=MIXTRAL_TWO_WAY_ARGS)
    return {"ns_rows": ns_rows, **out}


def serve_small_card_vs_cpu(dev, cases=SERVE_SMALL) -> dict:
    """11d: the reduced serving archs (starcoder2 with window 6, so the
    prompt of 12 wraps its ring; deepseek and its top-8 variant; 14a's
    recurrent archs) on the card against the same model on the CPU from
    the same params: prefill and 3 teacher-forced decode steps' logits
    within the arch's tolerance (TOL_SERVE_F32, or SERVE_SMALL_TOL's);
    greedy tokens equal wherever the CPU's top-2 margin exceeds 100 x
    that tolerance (none was nearer)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.layerwise import leaf_paths, tree_get, tree_unflatten
    from repro_torch.models.api import build_model
    from repro_torch.train.serve import Server
    out = {}
    for arch, window, moe in cases:
        tol = SERVE_SMALL_TOL.get(arch, TOL_SERVE_F32)
        cfg = get_config(arch).reduced()
        if window:
            cfg = dataclasses.replace(cfg, window=window)
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **moe))
        tag = arch + (" top-8" if moe else "")
        model = build_model(cfg)
        params, _ = model.init(torch.Generator().manual_seed(0), "cpu")
        paths = leaf_paths(params)
        cparams = tree_unflatten(paths, [tree_get(params, p).to(dev)
                                         for p in paths])
        s, n = 12, 3
        toks = torch.randint(0, cfg.vocab, (2, s + n),
                             generator=torch.Generator().manual_seed(1))
        worst = 0.0
        for p, d in ((params, "cpu"), (cparams, dev)):
            cache = model.init_cache(2, 32, d)
            lg, cache = model.prefill(p, {"tokens": toks[:, :s].to(d)},
                                      cache)
            seq = [lg.cpu()]
            for i in range(n):
                lg, cache = model.decode_step(p, {
                    "token": toks[:, s + i:s + i + 1].to(d), "t": s + i},
                    cache)
                seq.append(lg.cpu())
            if d == "cpu":
                want = seq
            else:
                worst = max((a - b).abs().max().item()
                            for a, b in zip(seq, want))
        ref_toks = Server(model).generate(params, {"tokens": toks[:, :s]}, 6)
        card_toks = Server(model).generate(
            cparams, {"tokens": toks[:, :s].to(dev)}, 6).cpu()
        # the CPU's margins along its own tokens
        cache = model.init_cache(2, s + 6, "cpu")
        lg, cache = model.prefill(params, {"tokens": toks[:, :s]}, cache)
        margins = []
        for i in range(6):
            top2 = torch.topk(lg, 2, dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])
            lg, cache = model.decode_step(
                params, {"token": ref_toks[:, i:i + 1], "t": s + i}, cache)
        margins = torch.stack(margins, 1)
        decided = margins > 100 * tol
        agree = bool(((ref_toks == card_toks) | ~decided).all())
        out[tag] = {"max_abs_err": worst, "tokens_equal":
                    torch.equal(ref_toks, card_toks),
                    "min_margin": margins.min().item()}
        emit({"check": f"reduced {tag} serving, cuda vs cpu", **out[tag],
              "tol": tol})
        if not worst <= tol or not agree:
            fail(f"reduced {tag} serving on the card drifts from the CPU: "
                 f"{out[tag]}")
    return out


def mixtral_small_card_vs_cpu() -> float:
    """11d: reduced mixtral, 3 two-way steps from one init, card against
    CPU (TOL_SLICE_LOSS, as phase 10's dense archs)."""
    from repro_torch.launch import train as train_cli
    argv = ["--arch", MIXTRAL] + DENSE_SMALL_ARGS
    on_card = train_cli.main(argv + ["--device", "cuda"])
    on_cpu = train_cli.main(argv + ["--device", "cpu"])
    gap = max(abs(a - b) for a, b in zip(on_card["losses"],
                                         on_cpu["losses"]))
    emit({"check": f"reduced {MIXTRAL} losses, w2s top10+natural, s2w "
          "natural, cuda vs cpu", "losses": on_card["losses"],
          "max_abs_diff": gap, "tol": TOL_SLICE_LOSS})
    if len(on_card["losses"]) != 3 or not gap <= TOL_SLICE_LOSS:
        fail(f"reduced {MIXTRAL} on the card drifts from the CPU run: {gap}")
    return gap


def phase11(dev, gen) -> dict:
    """Phase 11: serving at full width, Mixtral served and trained at full
    width, and the reduced archs card against CPU."""
    import torch
    t_phase = time.perf_counter()
    serve = serve_phase(dev, gen)
    train = mixtral_train_phase(dev, gen)
    small = serve_small_card_vs_cpu(dev)
    gap = mixtral_small_card_vs_cpu()
    torch.cuda.empty_cache()
    res = {"phase": "11 serving and mixtral",
           "wall_s": time.perf_counter() - t_phase,
           "serve": {a: {k: r[k] for k in (
               "prefill_s", "decode_ms_per_token", "decode_bound_ms",
               "peak_mem_bytes", "decode_vs_full", "decode_vs_full_bf16",
               "cache_capacity")}
               for a, r in serve.items() if a != "sharded_ref"},
           "mixtral_train": {k: train[k] for k in (
               "unpacked", "packed", "two_way")},
           "reduced_serving_card_vs_cpu": small,
           "reduced_mixtral_card_vs_cpu": gap}
    emit(res)
    train["sharded_ref"] = serve.pop("sharded_ref")
    return train


# ------------------------------------------------------------ phase 11b
# Sharded serving: mixtral-8x7b at full width and SERVE's depth (4 of 32
# layers, 8 x (1024 + 32)) over a (data=1, model=2) mesh of two processes
# on cuda:0 over gloo (NCCL refuses two ranks on one device, so every
# collective goes through pinned host memory: its times are not a
# link's). Each rank draws its chunks a leaf at a time from phase 11's
# seed; its tokens and logits are held against phase 11's one-rank run.
# The logits' gate is in f32 at the no-drop capacity, as phase 11's
# decode check: in bf16 a cut product's other cuBLAS kernel moves the
# logits by ~0.05 (1 + |logit|) over 8 layers, and at a decode step's
# capacity of 3 slots an expert flipped by a near-tie changes which
# tokens drop (1.18 at a forced step on the card, PERF.md §6); bf16 is
# reported.
SHARDED_MESH = {"data": 1, "model": 2}
SHARDED_F32_ROWS = 2
# a rank's bytes at rest, param_pspecs' and serve_pspecs' at this mesh
# (the experts cut on E, every other matrix on its last dim, the cache
# on its 1056 slots)
SHARDED_WEIGHT_BYTES = 6_067_265_536     # 11_872_378_880 at 8 layers
SHARDED_CACHE_BYTES = 69_206_016         # 138_412_032 at 8 layers
SHARDED_JOIN_S = 420


def sharded_serve_child(rank: int, tmp: str) -> None:
    """One of phase 11b's two ranks: draw, two greedy runs, prefill and
    DECODE_CHECK_STEPS decode steps fed phase 11's tokens; then its
    chunks upcast to f32 in place and the forced steps again at the
    no-drop capacity on SHARDED_F32_ROWS rows; writes what the parent
    checks to ``tmp/rank<r>.json``."""
    import dataclasses
    import os
    import traceback
    sys.path.insert(0, str(SRC))
    out: dict = {}
    try:
        import torch
        import torch.distributed as dist
        from repro_torch.configs import get_config
        from repro_torch.dist.sharding import (MeshShape, param_pspecs,
                                               serve_pspecs, spec_bytes)
        from repro_torch.models.api import abstract_params, build_model
        from repro_torch.train.serve import Server
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(tmp, "store"), 2), rank=rank, world_size=2)
        ref = torch.load(os.path.join(tmp, "ref.pt"))
        layers, bsz, prompt_len, new = SERVE[MIXTRAL]
        model = build_model(get_config(MIXTRAL).with_depth(layers))
        mesh = MeshShape(**SHARDED_MESH)
        srv = Server(model, mesh=mesh, group=dist.group.WORLD)
        abstract, metas = abstract_params(model)
        spec = model.cache_spec(bsz, prompt_len + new)
        out["spec_weight_bytes"] = spec_bytes(
            abstract, param_pspecs(abstract, metas, mesh), mesh)
        out["spec_cache_bytes"] = spec_bytes(spec, serve_pspecs(
            spec, bsz, mesh,
            cache_alt=model.cache_spec(bsz + 1, prompt_len + new)), mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = srv.draw(torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        out.update(draw_s=time.perf_counter() - t0,
                   draw_peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   weight_bytes=_nbytes(params))
        prompt = {"tokens": ref["prompt"].to(dev)}
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        runs = []
        for _ in range(2):
            toks = srv.generate(params, prompt, new)
            runs.append({"tokens": toks.cpu().tolist(),
                         "timings": dict(srv.timings)})
        logits, cache_bytes = forced_logits(
            srv, params, prompt, ref["tokens"], DECODE_CHECK_STEPS,
            prompt_len + new)
        torch.cuda.synchronize()
        out.update(runs=runs, cache_bytes=cache_bytes,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   forced_max_rel_err=_rel_errs(logits, ref["logits"]))
        del srv
        cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(
            model.cfg.moe, capacity_factor=NO_DROP_CAPACITY))
        srv32 = Server(to_f32_model(cfg, params), mesh=mesh,
                       group=dist.group.WORLD)
        rows = {"tokens": prompt["tokens"][:SHARDED_F32_ROWS]}
        logits, _ = forced_logits(
            srv32, srv32.place(params, chunks=True), rows,
            ref["tokens"][:SHARDED_F32_ROWS], DECODE_CHECK_STEPS,
            prompt_len + new)
        out.update(launches=all_launches(),
                   forced_f32_max_rel_err=_rel_errs(logits,
                                                    ref["logits_f32"]))
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        out["error"] = traceback.format_exc()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _rel_errs(got, want) -> list[float]:
    """max |got - want| / (1 + |want|) of each step of ``[steps, B, V]``."""
    return [float(((a - b).abs() / (1 + b.abs())).max())
            for a, b in zip(got, want)]


def sharded_serve_phase(ref: dict) -> dict:
    """11b: mixtral served by two ranks over a (data=1, model=2) mesh.
    Fails unless each rank holds the specs' bytes of weights and cache
    (SHARDED_WEIGHT_BYTES, SHARDED_CACHE_BYTES), its serving peak is
    below phase 11's one-rank peak, two greedy runs give the same tokens
    on both ranks, prefill's and DECODE_CHECK_STEPS teacher-forced decode
    steps' f32 logits (no-drop capacity) are within TOL_DECODE (1 +
    |logit|) of phase 11's, and no kernel of the port launched; the bf16
    logits' distance is reported. Prints the first position where the
    tokens part from phase 11's, prefill s, decode ms a token, a decode
    step's collectives and bytes by tag and the host-staged seconds."""
    import os
    import shutil
    import tempfile
    import torch
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        torch.save({k: ref[k] for k in ("prompt", "tokens", "logits",
                                        "logits_f32")},
                   os.path.join(tmp, "ref.pt"))
        ctx = mp.start_processes(sharded_serve_child, args=(tmp,), nprocs=2,
                                 join=False, start_method="spawn")
        deadline = time.time() + SHARDED_JOIN_S
        done = False
        try:
            while not done and time.time() < deadline:
                done = ctx.join(timeout=5)
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        if not done:
            fail(f"sharded serving: not done in {SHARDED_JOIN_S} s")
        got = []
        for r in range(2):
            with open(f"{tmp}/rank{r}.json") as f:
                got.append(json.load(f))
            if "error" in got[r]:
                fail(f"sharded serving: rank {r} raised:\n{got[r]['error']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    one = ref["tokens"].tolist()
    _, bsz, _, new = SERVE[MIXTRAL]
    report = {"phase": "11b mixtral-8x7b served over (data=1, model=2), "
                       "two ranks on cuda:0 over gloo",
              "mesh": SHARDED_MESH, "one_rank_peak_mem_bytes":
                  ref["peak_mem_bytes"], "ranks": []}
    bad = []
    for r, res in enumerate(got):
        toks = [run["tokens"] for run in res["runs"]]
        tm = res["runs"][-1]["timings"]
        parted = [i for i in range(new)
                  if any(row[i] != o[i] for row, o in zip(toks[-1], one))]
        report["ranks"].append({
            "rank": r, "weight_bytes": res["weight_bytes"],
            "cache_bytes": res["cache_bytes"],
            "draw_s": res["draw_s"],
            "draw_peak_mem_bytes": res["draw_peak_mem_bytes"],
            "serving_peak_mem_bytes": res["peak_mem_bytes"],
            "prefill_s": tm["prefill_s"],
            "decode_ms_per_token": 1e3 * tm["decode_s"] / new,
            "first_run": {"prefill_s": res["runs"][0]["timings"]["prefill_s"],
                          "decode_ms_per_token": 1e3 * res["runs"][0][
                              "timings"]["decode_s"] / new},
            "decode_step_collectives": tm["decode_collectives"],
            "prefill_collective_bytes": tm["prefill_collective_bytes"],
            "host_staged_s": tm["host_staged_s"],
            "forced_bf16_max_rel_err": res["forced_max_rel_err"],
            "forced_f32_max_rel_err": res["forced_f32_max_rel_err"],
            "first_position_parting_from_one_rank":
                parted[0] if parted else None,
            "tokens_row0": toks[-1][0][:16]})
        if not (res["weight_bytes"] == res["spec_weight_bytes"]
                == SHARDED_WEIGHT_BYTES):
            bad.append(f"rank {r} holds {res['weight_bytes']} B of weights, "
                       f"the specs {res['spec_weight_bytes']}")
        if not (res["cache_bytes"] == res["spec_cache_bytes"]
                == SHARDED_CACHE_BYTES):
            bad.append(f"rank {r} holds {res['cache_bytes']} B of cache, "
                       f"the specs {res['spec_cache_bytes']}")
        if not res["peak_mem_bytes"] < ref["peak_mem_bytes"]:
            bad.append(f"rank {r} peaks at {res['peak_mem_bytes']} B, not "
                       f"below one rank's {ref['peak_mem_bytes']}")
        if toks[0] != toks[1] or toks[-1] != got[0]["runs"][-1]["tokens"]:
            bad.append(f"rank {r}: greedy runs differ")
        if not max(res["forced_f32_max_rel_err"]) <= TOL_DECODE:
            bad.append(f"rank {r}: f32 logits {res['forced_f32_max_rel_err']}"
                       f" from phase 11's, over {TOL_DECODE} (1 + |logit|)")
        if any(res["launches"].values()):
            bad.append(f"rank {r} launched the port's kernels "
                       f"{res['launches']}")
    report["wall_s"] = time.perf_counter() - t_phase
    report["timing_note"] = ("two ranks sharing one card: collectives through "
                             "pinned host memory and gloo, not a link")
    emit(report)
    if bad:
        fail("sharded serving: " + "; ".join(bad))
    return report


# ------------------------------------------------------------ phase 12
# DeepSeek-V3 (arXiv:2412.19437): multi-head latent attention with its
# absorbed latent cache, top-8 sigmoid routing with a shared expert after
# a dense layer, the MTP head. Reduced, card vs CPU, and the MoE's
# fixed-order combine bit for bit; served at full width with 1 dense and
# DEEPSEEK_SERVE_DEPTH MoE layers (256 experts, vocab 129,280); decode
# against the full forward in f32 on the training cut; the training cut
# trained (every per-layer width; depth, routed experts and vocab cut to
# fit one card); the NS kernels at its buckets.
DEEPSEEK = "deepseek-v3-671b"
DEEPSEEK_SERVE_DEPTH = 2
SERVE[DEEPSEEK] = (DEEPSEEK_SERVE_DEPTH, 4, 1024, 32)
MTP_WEIGHT = 0.3
# the training cut: vocab 129,280 -> 32,768 and 256 routed experts -> 16
# (a choice of 8 among 16 left), 1 dense and 1 MoE layer
DEEPSEEK_CUT = {"vocab": 32768, "n_experts": 16}
DEEPSEEK_STEPS = 3
# one worker: with two the EF21-Muon state alone (~22 B a parameter,
# 2.68 B parameters) takes 59 GB. One gradient pass of the cut takes
# 10.8, 18.8 and 35.7 GB over its bf16 params at batch 1, 2 and 4 x 1024
# (the f32 attention scores of 128 heads; NVIDIA H100 80GB HBM3), so
# batch 4 puts the donated one-worker step at ~73 GB
DEEPSEEK_WORKERS, DEEPSEEK_BATCH = 1, 4
DEEPSEEK_ARGS = ["--arch", DEEPSEEK, "--steps", str(DEEPSEEK_STEPS),
                 "--seq", "1024", "--batch", str(DEEPSEEK_BATCH),
                 "--workers", str(DEEPSEEK_WORKERS), "--w2s", "top10",
                 "--s2w", "identity", "--beta", "0.5", "--log-every", "1",
                 "--device", "cuda", "--donate"]
DEEPSEEK_TWO_WAY_ARGS = list(DEEPSEEK_ARGS)
DEEPSEEK_TWO_WAY_ARGS[DEEPSEEK_TWO_WAY_ARGS.index("--w2s") + 1] = \
    "top10+natural"
DEEPSEEK_TWO_WAY_ARGS[DEEPSEEK_TWO_WAY_ARGS.index("--s2w") + 1] = "natural"
# the NS buckets [B, m, n] of the cut: the router transposed; kv_b; kv_a,
# q_a transposed; q_b; the 16 experts' and the shared expert's e_gate,
# e_up and e_down transposed (each slice the published (2048, 7168));
# mtp/proj transposed; wo transposed; the dense MLPs (the dense layer's
# and the MTP block's)
DEEPSEEK_BUCKETS = ((1, 16, 7168), (3, 512, 32768), (3, 576, 7168),
                    (3, 1536, 7168), (3, 1536, 24576), (51, 2048, 7168),
                    (1, 7168, 14336), (3, 7168, 16384), (6, 7168, 18432))
WIRE[DEEPSEEK, 2] = {
    "w2s": {"top10": (282_139_860, 475_634_088, 211_392_936, 374_341_785,
                      61_656_270, 67_947_732, 16_515_075, 25_165_830,
                      6_193_155, 57_345),
            "top10+natural": (241_035_680, 406_270_788, 180_564_801,
                              308_831_979, 52_664_731, 58_038_690,
                              13_624_938, 20_761_812, 5_109_354, 47_310)},
    "s2w": {"natural": (528_764_928, 891_813_888, 396_361_728, 842_268_672,
                        115_605_504, 127_401_984, 37_158_912, 56_623_104,
                        13_934_592, 129_024)},
    "order": (1, 3, 0, 2, 5, 4, 7, 6, 8, 9)}
# decode against the full forward on the cut: batch, prompt; the capacity
# factor E/K = 2 gives every expert T slots, so no token is dropped at
# any token count
DEEPSEEK_DECODE = (2, 256)


def deepseek_cut(capacity_factor: float | None = None):
    """The training cut of deepseek-v3-671b (``DEEPSEEK_CUT``), at
    ``capacity_factor`` if given."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(DEEPSEEK)
    moe = dataclasses.replace(cfg.moe, n_experts=DEEPSEEK_CUT["n_experts"])
    if capacity_factor is not None:
        moe = dataclasses.replace(moe, capacity_factor=capacity_factor)
    return dataclasses.replace(cfg.with_depth(1), vocab=DEEPSEEK_CUT["vocab"],
                               moe=moe)


def deepseek_small_card_vs_cpu() -> dict:
    """12a: reduced deepseek (4 experts, top-2) and its top-8 variant
    (16 experts), 3 two-way steps from one init through ``setup`` /
    ``run_steps``, card against CPU (TOL_SLICE_LOSS)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    base = get_config(DEEPSEEK).reduced()
    out = {}
    for tag, cfg in (("reduced", base), ("reduced top-8", dataclasses.replace(
            base, moe=dataclasses.replace(base.moe, **TOP8)))):
        losses = {}
        for d in ("cuda", "cpu"):
            args = train_cli.parse_args(["--arch", DEEPSEEK]
                                        + DENSE_SMALL_ARGS + ["--device", d])
            _, tr, data, sched = train_cli.setup(args, cfg=cfg)
            losses[d] = train_cli.run_steps(tr, tr.init(args.seed), data,
                                            sched, 3)["losses"]
        gap = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
        emit({"check": f"{tag} {DEEPSEEK} losses, w2s top10+natural, s2w "
              "natural, cuda vs cpu", "losses": losses["cuda"],
              "max_abs_diff": gap, "tol": TOL_SLICE_LOSS})
        if len(losses["cuda"]) != 3 or not gap <= TOL_SLICE_LOSS:
            fail(f"{tag} {DEEPSEEK} on the card drifts from the CPU run: "
                 f"{gap}")
        out[tag] = gap
    return out


def expert_major_adds(vals, tok, valid, n_tok: int, cap: int):
    """The reference's scatter-add on the CPU, one expert at a time:
    each expert's valid slots (distinct tokens) added to their tokens,
    one rounded add of ``vals``' dtype each, experts in ascending id."""
    import torch
    vals, tok, valid = vals.cpu(), tok.cpu(), valid.cpu()
    out = torch.zeros((n_tok, vals.shape[1]), dtype=vals.dtype)
    for lo in range(0, len(tok), cap):
        v = valid[lo:lo + cap]
        t = tok[lo:lo + cap][v]
        out[t] = out[t] + vals[lo:lo + cap][v]
    return out


def combine_bits_check(dev, gen) -> dict:
    """12a: the MoE's fixed-order combine and the dispatch gather's
    gradient at full-width serving's prefill routing (4,096 tokens, 256
    experts, top-8, 160 slots an expert, d_model 7168, bf16) on the card,
    bit for bit against serial bf16 adds in ascending expert id on the
    CPU (``expert_major_adds``, the reference's order; tests hold it
    against XLA's scatter-add); the routing tables against the CPU's.
    Beside it, the card's ``index_add_`` of the same contributions,
    twice: atomics in an order that changes between runs."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.configs.base import MoECfg
    n_tok, n_exp, k, d = 4096, 256, 8, 7168
    cap = tfm.moe_capacity(MoECfg(n_exp, k, 2048, 1), n_tok)
    probs = torch.sigmoid(torch.randn(n_tok, n_exp, device=dev,
                                      generator=gen))
    _, top = tfm._top_k(probs, k)
    r = tfm.moe_route(top, n_exp, cap)
    rc = tfm.moe_route(top.cpu(), n_exp, cap)
    same_route = all(torch.equal(r[key].cpu(), rc[key]) for key in r)
    vals = torch.randn(n_exp * cap, d, device=dev, generator=gen).to(
        torch.bfloat16)
    vals = torch.where(r["valid"][:, None], vals, 0)
    got = tfm.moe_combine(vals, r)
    want = expert_major_adds(vals, r["tok"], r["valid"], n_tok, cap)
    combine_equal = torch.equal(got.cpu().view(torch.int16),
                                want.view(torch.int16))
    xf = torch.zeros(n_tok, d, dtype=torch.bfloat16, device=dev,
                     requires_grad=True)
    tfm.moe_dispatch(xf, r).backward(vals)
    grad_equal = torch.equal(xf.grad.cpu().view(torch.int16),
                             want.view(torch.int16))
    adds = [torch.zeros(n_tok, d, dtype=torch.bfloat16, device=dev)
            .index_add_(0, r["tok"], vals) for _ in range(2)]
    kept = int(r["kept"].sum())
    out = {"tokens": n_tok, "experts": n_exp, "top_k": k, "capacity": cap,
           "d_model": d, "kept_assignments": kept,
           "dropped_assignments": n_tok * k - kept, "routes_equal": same_route,
           "combine_bit_equal": combine_equal,
           "dispatch_grad_bit_equal": grad_equal,
           "index_add_runs_differ_in": int((adds[0] != adds[1]).sum()),
           "index_add_differs_from_fixed_order_in":
               int((adds[0] != got).sum()),
           "combine_ms": time_ms(lambda: tfm.moe_combine(vals, r), reps=5),
           "index_add_ms": time_ms(lambda: torch.zeros(
               n_tok, d, dtype=torch.bfloat16, device=dev).index_add_(
               0, r["tok"], vals), reps=5)}
    emit({"check": "MoE combine and dispatch gradient on the card vs the "
          "CPU's expert-major serial adds, bits",
          **out})
    if not (same_route and combine_equal and grad_equal):
        fail(f"the MoE's fixed-order combine on the card is not the CPU's: "
             f"{out}")
    del vals, got, xf, adds
    torch.cuda.empty_cache()
    return out


def deepseek_serve_phase(dev, gen) -> dict:
    """12b-c: deepseek served at full width (SERVE's depth: every weight
    drawn on the card), greedy twice, by ``serve_full``; then decode
    against the full forward on the training cut at capacity factor
    E/K (no drops), batch and prompt DEEPSEEK_DECODE, in f32 on the same
    weights within TOL_DECODE (bf16 reported)."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.api import build_model, make_batch
    served = serve_full(DEEPSEEK, dev, gen, phase=12)
    out = served["out"]
    del served
    torch.cuda.empty_cache()
    cut = deepseek_cut()
    cfg = deepseek_cut(cut.moe.n_experts / cut.moe.top_k)
    model = build_model(cfg)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    bsz, prompt = DEEPSEEK_DECODE
    tokens = make_batch(cfg, ShapeSpec("p", "prefill",
                                       prompt + DECODE_CHECK_STEPS, bsz),
                        gen, device=dev)["tokens"]
    tag = (f"{DEEPSEEK} cut ({cfg.n_layers} layers, {cfg.moe.n_experts} "
           f"experts, capacity {cfg.moe.capacity_factor})")
    out["decode_vs_full_bf16"] = decode_vs_full(f"{tag} bf16", model, params,
                                                tokens, gate=False)
    m32 = to_f32_model(cfg, params)
    out["decode_vs_full"] = decode_vs_full(f"{tag} f32", m32, params, tokens)
    del params, m32, tokens
    torch.cuda.empty_cache()
    return out


def deepseek_train_phase(dev, gen) -> dict:
    """12d-e: the training cut, DEEPSEEK_WORKERS worker(s), seq 1024,
    DEEPSEEK_STEPS donated steps through ``train_and_pack``: its NS
    buckets against DEEPSEEK_BUCKETS; unpacked top10 (a first loss near
    (1 + MTP_WEIGHT) ln(vocab)), packed top10 (losses bit-equal: the
    MoE's adds are in a fixed order, forward and backward), the two-way
    run under TWO_WAY_PEAK_LIMIT's rule; then the NS kernels at the
    cut's buckets (one iteration vs plain, the largest vs float64, timed
    vs cuBLAS f32 and the bound)."""
    import torch
    cfg = deepseek_cut()
    n_params = plan_buckets(DEEPSEEK_ARGS, cfg, DEEPSEEK_BUCKETS, "deepseek")
    out = train_and_pack(dev, DEEPSEEK_ARGS, cfg, f"{DEEPSEEK} cut",
                         DEEPSEEK_STEPS, n_params,
                         two_way_argv=DEEPSEEK_TWO_WAY_ARGS)
    ns_rows = ns_bucket_rows(dev, gen, DEEPSEEK_BUCKETS, "deepseek", reps=2)
    torch.cuda.empty_cache()
    return {"ns_rows": ns_rows, **out}


def phase12(dev, gen) -> dict:
    """Phase 12: deepseek-v3-671b. Reduced card vs CPU and the MoE's
    combine bit for bit; served at full width; decode vs the full forward
    on the cut; the cut trained; the NS kernels at its buckets."""
    import torch
    t_phase = time.perf_counter()
    small = deepseek_small_card_vs_cpu()
    bits = combine_bits_check(dev, gen)
    serve = deepseek_serve_phase(dev, gen)
    train = deepseek_train_phase(dev, gen)
    torch.cuda.empty_cache()
    res = {"phase": f"12 {DEEPSEEK}",
           "wall_s": time.perf_counter() - t_phase,
           "reduced_card_vs_cpu": small,
           "combine": {k: bits[k] for k in (
               "combine_bit_equal", "dispatch_grad_bit_equal",
               "index_add_runs_differ_in", "combine_ms", "index_add_ms")},
           "serve": {k: serve[k] for k in (
               "params", "prefill_s", "decode_ms_per_token",
               "decode_bound_ms", "peak_mem_bytes", "decode_vs_full",
               "decode_vs_full_bf16", "cache_capacity")},
           "train": {k: train[k] for k in ("unpacked", "packed", "two_way")},
           # the shapes the NS kernels had not met: kv_b's 512 x 512 gram
           # over K = 32,768 (10 upper tiles a slice) and kv_a's 576 rows
           "flagged_ns_buckets": {str(r["shape"]): {k: r[k] for k in (
               "ms", "gram_ms", "library_ms", "bound_ms",
               "fraction_of_bound")} for r in train["ns_rows"]
               if tuple(r["shape"]) in ((3, 512, 32768), (3, 576, 7168))}}
    emit(res)
    return train


# ------------------------------------------------------------ phase 13
# Qwen2-VL (arXiv:2409.12191: M-RoPE over patch-embedding prompts) and
# Whisper (arXiv:2212.04356: an encoder over 1500 frames, cross-attention,
# the cross K/V cache).
QWEN_VL = "qwen2-vl-7b"
WHISPER = "whisper-small"
# the training cut: every published width at 2 of 28 layers (1.56 B
# parameters, 1.09 B of them embed and unembed), 2 workers
QWEN_VL_DEPTH = 2
# the NS buckets [B, m, n] of the cut: wk and wv transposed; wq and wo;
# w_down transposed, w_gate, w_up
QWEN_VL_BUCKETS = ((4, 512, 3584), (4, 3584, 3584), (6, 3584, 18944))
# whisper-small's, encoder and decoder: every attention (self and cross)
# projection; the MLPs' w_up and w_down transposed
WHISPER_BUCKETS = ((144, 768, 768), (48, 768, 3072))
WIRE[QWEN_VL, QWEN_VL_DEPTH] = {
    "w2s": {"top10": (654_105_400, 244_423_080, 25_690_120, 3_670_020),
            "top10+natural": (558_730_860, 208_778_052, 21_194_352,
                              3_027_768)},
    "s2w": {"natural": (1_226_352_640, 458_293_248, 57_802_752,
                        8_257_536)},
    "order": (0, 1, 2, 3)}
WIRE[WHISPER, 12] = {
    "w2s": {"top10": (63_279_210, 42_467_760, 56_623_200),
            "top10+natural": (54_106_544, 35_035_920, 46_714_176)},
    "s2w": {"natural": (118_315_200, 95_551_488, 127_401_984)},
    "order": (2, 0, 1)}
# served whole: batch 8, a prompt of 2048 patch embeddings (M-RoPE ids
# drawn by make_batch) and 64 new tokens; Whisper over its 1500 frames
# with a 4-token prompt and 64 new
SERVE[QWEN_VL] = (None, 8, 2048, 64)
SERVE[WHISPER] = (None, 8, 4, 64)
# the cut's run: seq 1024, batch 4 (2 workers of 2 rows), 3 donated steps
# (the EF21 state written in place); the peak predicted before the first
# run on the card (PERF.md): the state at 22 B a parameter (34.2
# GB), then embed's TopK, a stable sort of 2 x 545 M bf16 magnitudes with
# int64 indices (~24 GB of sort buffers beside ~6.5 GB of the EF21
# difference), so ~64 GB; under TWO_WAY_PEAK_LIMIT, hence 2 workers at
# depth 2 rather than 1 worker at depth 4 (measured 65.0 GB on an NVIDIA
# H100 80GB HBM3 at 700.00 W)
QWEN_VL_STEPS, QWEN_VL_BATCH = 3, 4
QWEN_VL_PEAK_PREDICTED = 64e9
QWEN_VL_ARGS = ["--arch", QWEN_VL, "--steps", str(QWEN_VL_STEPS),
                "--seq", "1024", "--batch", str(QWEN_VL_BATCH),
                "--workers", "2", "--w2s", "top10", "--s2w", "identity",
                "--beta", "0.5", "--log-every", "1", "--device", "cuda",
                "--donate"]
# Whisper trained whole: 2 workers, batch 8 x 448 (its text context), the
# server's update Natural-compressed back (rows 3, 4 and 7 on its path)
WHISPER_STEPS = 3
WHISPER_ARGS = ["--arch", WHISPER, "--steps", str(WHISPER_STEPS),
                "--seq", "448", "--batch", "8", "--workers", "2",
                "--w2s", "top10", "--s2w", "natural", "--beta", "0.5",
                "--log-every", "1", "--device", "cuda"]


def vlm_audio_small_card_vs_cpu() -> dict:
    """13a: reduced qwen2-vl (patch embeddings, M-RoPE) and reduced whisper
    (64 frames), 3 two-way steps from one init through the CLI, card
    against CPU (TOL_SLICE_LOSS)."""
    from repro_torch.launch import train as train_cli
    out = {}
    for arch in (QWEN_VL, WHISPER):
        argv = ["--arch", arch] + DENSE_SMALL_ARGS
        on_card = train_cli.main(argv + ["--device", "cuda"])
        on_cpu = train_cli.main(argv + ["--device", "cpu"])
        gap = max(abs(a - b) for a, b in zip(on_card["losses"],
                                             on_cpu["losses"]))
        emit({"check": f"reduced {arch} losses, w2s top10+natural, s2w "
              "natural, cuda vs cpu", "losses": on_card["losses"],
              "max_abs_diff": gap, "tol": TOL_SLICE_LOSS})
        if len(on_card["losses"]) != 3 or not gap <= TOL_SLICE_LOSS:
            fail(f"reduced {arch} on the card drifts from the CPU run: {gap}")
        out[arch] = gap
    return out


def decode_check_prompt(served: dict, gen, n: int = DECODE_CHECK_STEPS):
    """The first 2 rows of ``served``'s prompt and ``n`` random tokens to
    decode after it (teacher-forced)."""
    import torch
    prompt = {k: v[:2] for k, v in served["batch"].items()}
    toks = torch.randint(0, served["cfg"].vocab, (2, n), generator=gen,
                         device=gen.device).to(torch.int32)
    return prompt, toks


def serve_vlm_audio(arch: str, dev, gen) -> dict:
    """13b-c, 13e's serving: ``arch`` served whole by ``serve_full``
    (greedy twice, prefill s, decode ms a token against its bytes bound,
    busy share and launches a step, peak, no kernel of the port
    launched); then decode after its prompt (Qwen2-VL's patch embeddings,
    Whisper's frames) against the full forward on 2 rows, in bf16
    (reported) and in f32 on the same weights within TOL_DECODE."""
    import torch
    served = serve_full(arch, dev, gen, phase=13)
    out = served["out"]
    prompt, toks = decode_check_prompt(served, gen)
    model, params, cfg = served["model"], served["params"], served["cfg"]
    del served
    out["decode_vs_full_bf16"] = decode_vs_full(
        f"{arch} bf16", model, params, toks, gate=False, prompt=prompt)
    m32 = to_f32_model(cfg, params)
    out["decode_vs_full"] = decode_vs_full(f"{arch} f32", m32, params, toks,
                                           prompt=prompt)
    del model, m32, params, prompt, toks
    torch.cuda.empty_cache()
    return out


def phase13(dev, gen) -> dict:
    """Phase 13: qwen2-vl-7b and whisper-small. Reduced card vs CPU;
    qwen2-vl served whole after a patch-embedding prompt; whisper served
    whole over 1500 frames; decode vs the full forward in f32 for both;
    qwen2-vl's training cut (every width, QWEN_VL_DEPTH layers) and
    whisper at full size trained, unpacked and packed; the NS kernels at
    their buckets."""
    import torch
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    small = vlm_audio_small_card_vs_cpu()
    torch.cuda.empty_cache()
    serve = {arch: serve_vlm_audio(arch, dev, gen)
             for arch in (QWEN_VL, WHISPER)}
    cut = get_config(QWEN_VL).with_depth(QWEN_VL_DEPTH)
    n_cut = plan_buckets(QWEN_VL_ARGS, cut, QWEN_VL_BUCKETS, "qwen2_vl")
    emit({"qwen2_vl_cut_predicted_peak_bytes": QWEN_VL_PEAK_PREDICTED,
          "limit": TWO_WAY_PEAK_LIMIT, "workers": 2,
          "depth": QWEN_VL_DEPTH})
    vl = train_and_pack(dev, QWEN_VL_ARGS, cut,
                        f"{QWEN_VL} x {QWEN_VL_DEPTH} layers", QWEN_VL_STEPS,
                        n_cut)
    torch.cuda.empty_cache()
    wcfg = get_config(WHISPER)
    n_w = plan_buckets(WHISPER_ARGS, wcfg, WHISPER_BUCKETS, "whisper")
    wh = train_and_pack(dev, WHISPER_ARGS, wcfg, WHISPER, WHISPER_STEPS,
                        n_w)
    torch.cuda.empty_cache()
    ns_rows = ns_bucket_rows(dev, gen, QWEN_VL_BUCKETS + WHISPER_BUCKETS,
                             "qwen2_vl_whisper", reps=3)
    torch.cuda.empty_cache()
    res = {"phase": f"13 {QWEN_VL} and {WHISPER}",
           "wall_s": time.perf_counter() - t_phase,
           "reduced_card_vs_cpu": small,
           "serve": {a: {k: r[k] for k in (
               "params", "prefill_s", "decode_ms_per_token",
               "decode_bound_ms", "decode_fraction_of_bound",
               "peak_mem_bytes", "decode_vs_full", "decode_vs_full_bf16",
               "cache_capacity")} | {
               "busy_share": 1.0 - r["decode_profile"]["host_share"],
               "launches_per_step":
                   r["decode_profile"]["launches_per_step"]}
               for a, r in serve.items()},
           "train": {QWEN_VL: {k: vl[k] for k in ("unpacked", "packed")},
                     WHISPER: {k: wh[k] for k in ("unpacked", "packed")}}}
    emit(res)
    return {"ns_rows": ns_rows, "qwen_vl_launches": vl["launches"],
            "whisper_launches": wh["launches"]}


# ------------------------------------------------------------ phase 14
# The recurrent families: RecurrentGemma (arXiv:2402.19427: the RG-LRU
# scan, the causal conv, local MQA attention over a 2048 ring, the
# pattern's remainder stack) and xLSTM[7:1] (arXiv:2405.04517: the
# chunkwise mLSTM, the serial sLSTM).
GRIFFIN = "recurrentgemma-2b"
XLSTM = "xlstm-1.3b"
# served: griffin whole, 26 layers (8 periods + the 2-layer remainder),
# after a prompt of twice its window, so the ring wraps; xlstm at 1 of
# its 6 periods (7 mLSTM + 1 sLSTM, every width), cut when phase 9s came
# (served whole, 48 layers, it took ~84 of phase 14's ~216 s; PERF.md
# §6)
SERVE[GRIFFIN] = (None, 8, 4096, 64)
SERVE[XLSTM] = (1, 8, 2048, 64)
# the training cuts: griffin 2 periods (6 layers, 1,169,277,440
# parameters, 655 M of them the tied embed), xlstm 1 period (7 mLSTM + 1
# sLSTM, 772,689,976)
GRIFFIN_DEPTH, XLSTM_DEPTH = 2, 1
# the NS buckets [B, m, n] of the cuts. griffin: w_gate, w_x, w_r, w_i,
# w_out, wq, wo; the MLPs; wk, wv transposed (MQA, hd 256); conv_w [4,
# 2560]. xlstm: wq, wk, wv; w_up and the sLSTM's w_gates; w_down
# transposed; w_if transposed; r_gates' 4 x 4 heads of [512, 512]; the
# sLSTM's GeGLU (2048 x 2752)
GRIFFIN_BUCKETS = ((24, 2560, 2560), (18, 2560, 7680), (4, 256, 2560),
                   (4, 4, 2560))
XLSTM_BUCKETS = ((21, 4096, 4096), (8, 2048, 8192), (7, 2048, 4096),
                 (7, 8, 4096), (16, 512, 512), (3, 2048, 2752))
WIRE[GRIFFIN, 3 * GRIFFIN_DEPTH] = {
    "w2s": {"top10": (393_512_960, 212_336_640, 78_643_200, 1_310_720,
                      16_384),
            "top10+natural": (336_168_960, 181_370_880, 64_880_640,
                              1_081_344, 12_800)},
    "s2w": {"natural": (737_576_960, 398_131_200, 176_947_200, 2_949_120,
                        46_080)},
    "order": (0, 1, 2, 3, 4)}
WIRE[XLSTM, 8 * XLSTM_DEPTH] = {
    "w2s": {"top10": (123_840_336, 176_160_810, 67_108_880, 29_360_135,
                      8_454_150, 2_097_200, 91_756),
            "top10+natural": (105_811_382, 145_332_684, 55_364_832,
                              24_222_114, 6_974_676, 1_730_192, 71_687)},
    "s2w": {"natural": (232_014_048, 396_361_728, 150_994_944, 66_060_288,
                        19_021_824, 4_718_592, 258_048)},
    "order": (1, 0, 2, 3, 4, 5, 6)}
# the cuts' runs: 2 workers, seq 1024, batch 4, 3 donated steps, top10;
# griffin's peak predicted before the first run on the card (PERF.md):
# the donated state at 22 B a parameter (25.7 GB), then embed's TopK, a
# stable sort of 2 x 655 M bf16 magnitudes with int64 indices (~29 GB)
# beside the EF21 difference (~7.9 GB), so ~63 GB < TWO_WAY_PEAK_LIMIT
RECURRENT_STEPS = 3
GRIFFIN_PEAK_PREDICTED = 63e9
# reduced card vs CPU, the loss of step 2: xLSTM's follows TopK's and the
# sign LMO's picks on embed, whose f32 gradient sits ~5e-4 from float64
# on either side (tests/test_torch_xlstm.py): on the CPU the run on
# float64 gradients moves it by 0.0124, the card by 0.0218 (an NVIDIA
# H100 80GB HBM3), so it is held at 0.05; steps 0-1 at TOL_SLICE_LOSS
SMALL_LOSS_TOL = {XLSTM: 0.05}
# decode against the full forward: xLSTM's f32 gap grows with depth, each
# mLSTM normaliser max(|q.n|, exp(-m)) amplifying the last one's
# rounding (tests/test_torch_xlstm.py), so at 48 layers (3.12 in f32)
# and at the served cut it is held in float64, which leaves only
# the logits' f32 cast, and the f32 gap is reported
DECODE_CHECK_DTYPE = {XLSTM: "float64"}


def recurrent_args(arch: str) -> list:
    return ["--arch", arch, "--steps", str(RECURRENT_STEPS), "--seq",
            "1024", "--batch", "4", "--workers", "2", "--w2s", "top10",
            "--s2w", "identity", "--beta", "0.5", "--log-every", "1",
            "--device", "cuda", "--donate"]


@contextlib.contextmanager
def float64_gradients():
    """``Trainer._grad_and_loss`` on a float64 copy of the model and its
    params, the loss and gradients cast back to the params' dtypes: the
    same run with only the gradients' rounding changed, a control for a
    trajectory that hangs on TopK's and the sign LMO's picks."""
    import dataclasses
    from repro_torch.dist.layerwise import leaf_paths, tree_get, tree_unflatten
    from repro_torch.models.api import build_model
    from repro_torch.train.trainer import Trainer
    plain = Trainer._grad_and_loss

    def grad_and_loss(self, params, batch):
        paths = leaf_paths(params)
        p64 = tree_unflatten(paths, [tree_get(params, q).double()
                                     for q in paths])
        model = self.model
        self.model = build_model(dataclasses.replace(model.cfg,
                                                     dtype="float64"))
        try:
            loss, grads = plain(self, p64, batch)
        finally:
            self.model = model
        return loss.float(), tree_unflatten(paths, [
            tree_get(grads, q).to(tree_get(params, q).dtype)
            for q in paths])

    Trainer._grad_and_loss = grad_and_loss
    try:
        yield
    finally:
        Trainer._grad_and_loss = plain


def recurrent_small_card_vs_cpu(dev) -> dict:
    """14a: reduced recurrentgemma-2b and xlstm-1.3b, 3 two-way steps from
    one init through the CLI, card against CPU, beside the control: the
    CPU run again on float64 gradients (``float64_gradients``). Steps 0-1
    read the initial W only (the s2w leg first moves W in step 2) and are
    held at TOL_SLICE_LOSS; step 2 at the arch's SMALL_LOSS_TOL. Then
    both served reduced, card against CPU (griffin with window 6, so the
    prompt of 12 wraps its ring)."""
    from repro_torch.launch import train as train_cli
    out = {}
    for arch in (GRIFFIN, XLSTM):
        argv = ["--arch", arch] + DENSE_SMALL_ARGS
        on_card = train_cli.main(argv + ["--device", "cuda"])["losses"]
        on_cpu = train_cli.main(argv + ["--device", "cpu"])["losses"]
        with float64_gradients():
            control = train_cli.main(argv + ["--device", "cpu"])["losses"]
        gaps = [abs(a - b) for a, b in zip(on_card, on_cpu)]
        ctl = max(abs(a - b) for a, b in zip(control, on_cpu))
        tol = SMALL_LOSS_TOL.get(arch, TOL_SLICE_LOSS)
        emit({"check": f"reduced {arch} losses, w2s top10+natural, s2w "
              "natural, cuda vs cpu", "losses": on_card,
              "max_abs_diff": max(gaps), "steps_0_1_max_abs_diff":
              max(gaps[:2]), "cpu_float64_gradients_max_abs_diff": ctl,
              "tol": {"steps 0-1": TOL_SLICE_LOSS, "step 2": tol}})
        if len(on_card) != 3 or not max(gaps[:2]) <= TOL_SLICE_LOSS \
                or not gaps[2] <= tol:
            fail(f"reduced {arch} on the card drifts from the CPU run: "
                 f"{gaps}")
        out[arch] = {"max_abs_diff": max(gaps), "control": ctl}
    out["serving"] = serve_small_card_vs_cpu(
        dev, ((GRIFFIN, 6, None), (XLSTM, None, None)))
    return out


def slstm_loop_launches(model, params, steps: int = 64) -> dict:
    """xlstm's sLSTM scan alone on the card: the first block's serial loop
    over ``steps`` tokens at batch 8 (bf16, as served), under
    ``torch.profiler``: kernel launches and host ms a token (the loop runs
    6 x S steps a prefill)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import xlstm
    from repro_torch.models.common import slot
    cfg = model.cfg
    p = slot(params["s_blocks"], 0)
    x = torch.randn((8, steps, cfg.d_model), device=params["embed"].device,
                    dtype=params["embed"].dtype)
    with torch.inference_mode():
        xlstm._slstm_block(cfg, p, 0, x, None, "full")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            xlstm._slstm_block(cfg, p, 0, x, None, "full")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    launches = sum(e.count for e in prof.key_averages() if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    out = {"slstm_block_tokens": steps, "launches": launches,
           "launches_per_token": launches / steps,
           "ms_per_token": 1e3 * wall / steps}
    emit({"xlstm sLSTM loop": out})
    return out


def serve_recurrent(arch: str, dev, gen) -> dict:
    """14b-c: ``arch`` served at SERVE's depth by ``serve_full`` (greedy
    twice, prefill s, decode ms a token against its bytes bound, busy
    share and launches a step, peak, no kernel of the port launched);
    decode after 2 rows of its prompt against the full forward (the scans
    over every position), in bf16 (reported) and in f32 on the same
    weights within TOL_DECODE; xlstm's in f32 reported and in float64
    within TOL_DECODE (DECODE_CHECK_DTYPE)."""
    import torch
    served = serve_full(arch, dev, gen, phase=14)
    out = served["out"]
    if arch == GRIFFIN and (out["cache_capacity"] != served["cfg"].window
                            or out["prompt"] <= out["cache_capacity"]):
        fail(f"{arch}: a ring of {out['cache_capacity']} that the prompt of "
             f"{out['prompt']} does not wrap")
    prompt, toks = decode_check_prompt(served, gen)
    model, params, cfg = served["model"], served["params"], served["cfg"]
    del served
    if arch == XLSTM:
        out["slstm_loop"] = slstm_loop_launches(model, params)
    out["decode_vs_full_bf16"] = decode_vs_full(
        f"{arch} bf16", model, params, toks, gate=False, prompt=prompt)
    m32 = to_f32_model(cfg, params)
    check = DECODE_CHECK_DTYPE.get(arch, "float32")
    out["decode_vs_full_f32"] = decode_vs_full(
        f"{arch} f32", m32, params, toks, gate=check == "float32",
        prompt=prompt)
    out["decode_vs_full"] = out["decode_vs_full_f32"]
    if check != "float32":
        m32 = to_f32_model(cfg, params, check)
        out["decode_vs_full"] = out["decode_vs_full_" + check] = \
            decode_vs_full(f"{arch} {check}", m32, params, toks,
                           prompt=prompt)
    del model, m32, params, prompt, toks
    torch.cuda.empty_cache()
    return out


def phase14(dev, gen) -> dict:
    """Phase 14: recurrentgemma-2b and xlstm-1.3b. Reduced card vs CPU,
    trained and served; both served (xlstm at SERVE's depth), decode vs the
    full forward in f32; their training cuts (every width; GRIFFIN_DEPTH
    periods, its peak predicted first; XLSTM_DEPTH) trained unpacked and packed
    top10, the NS buckets asserted from the plan; the NS kernels at their
    buckets."""
    import torch
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    small = recurrent_small_card_vs_cpu(dev)
    torch.cuda.empty_cache()
    serve = {arch: serve_recurrent(arch, dev, gen)
             for arch in (GRIFFIN, XLSTM)}
    train = {}
    for arch, depth, buckets in ((GRIFFIN, GRIFFIN_DEPTH, GRIFFIN_BUCKETS),
                                 (XLSTM, XLSTM_DEPTH, XLSTM_BUCKETS)):
        cut = get_config(arch).with_depth(depth)
        argv = recurrent_args(arch)
        n_cut = plan_buckets(argv, cut, buckets, arch.split("-")[0])
        if arch == GRIFFIN:
            emit({"griffin_cut_predicted_peak_bytes": GRIFFIN_PEAK_PREDICTED,
                  "limit": TWO_WAY_PEAK_LIMIT, "workers": 2, "depth": depth})
        train[arch] = train_and_pack(
            dev, argv, cut, f"{arch} x {cut.n_layers} layers",
            RECURRENT_STEPS, n_cut)
        torch.cuda.empty_cache()
    ns_rows = ns_bucket_rows(dev, gen, GRIFFIN_BUCKETS + XLSTM_BUCKETS,
                             "griffin_xlstm", reps=3)
    torch.cuda.empty_cache()
    res = {"phase": f"14 {GRIFFIN} and {XLSTM}",
           "wall_s": time.perf_counter() - t_phase,
           "reduced_card_vs_cpu": small,
           "serve": {a: {k: r[k] for k in (
               "params", "prefill_s", "decode_ms_per_token",
               "decode_bound_ms", "decode_fraction_of_bound",
               "peak_mem_bytes", "decode_vs_full", "decode_vs_full_f32",
               "decode_vs_full_bf16", "cache_capacity")} | {
               "busy_share": 1.0 - r["decode_profile"]["host_share"],
               "launches_per_step":
                   r["decode_profile"]["launches_per_step"],
               "slstm_loop": r.get("slstm_loop")}
               for a, r in serve.items()},
           "train": {a: {k: t[k] for k in ("unpacked", "packed")}
                     for a, t in train.items()}}
    emit(res)
    return {"ns_rows": ns_rows,
            "griffin_launches": train[GRIFFIN]["launches"],
            "xlstm_launches": train[XLSTM]["launches"]}


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
                             iters, keep_state=True)
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
    checkpoint_run()
    crash_run()
    stall_run(out)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        faulted = fault_run(dist.group.WORLD, n_buckets)
        obs = obs_run(dist.group.WORLD, two_way)
        # ---- 8.7 the desynchronized-worker rejoin (--resync)
        torch.cuda.empty_cache()
        resynced = resync_run(dist.group.WORLD, two_way, n_buckets)
    finally:
        dist.destroy_process_group()
    # ---- 9. the worker axis over two ranks on the one card (gloo): the
    # bucket split, the zero-1 and FSDP placements, reduced mixtral, and
    # 9s the supervisor over the two; 9b the NS chain on a rank's share of
    # the largest buckets
    from repro_torch.obs.trace import PHASE_SPANS
    ranked = two_rank_run(two_way, resynced, obs["spans"][PHASE_SPANS[4]],
                          smi)
    torch.cuda.empty_cache()
    split_rows = split_bucket_rows(dev, gen, smi)

    # ---- 9c. nanogpt-124m trained over a (data=2, model=2) mesh of four
    # ranks on the one card (gloo), against one process; the NS chains at
    # a rank's chunk shapes
    torch.cuda.empty_cache()
    one_mesh = mesh_one_process()
    meshed = mesh_train_phase(smi, one_mesh)

    # ---- 9d. the same run over a (pod=2, data=2, model=1) mesh: a worker
    # a pod, a row a rank; the NS chains at a rank's (pod, data) rows
    torch.cuda.empty_cache()
    podded = pod_train_phase(smi, one_mesh)

    # ---- 10. the dense zoo: the reduced archs card vs CPU, then
    # qwen2.5-3b at full width (QWEN_DEPTH layers), then all 36 layers
    torch.cuda.empty_cache()
    dense = dense_zoo_phase(dev, gen)

    # ---- 11. serving at full width (qwen2.5-3b, starcoder2-15b's ring),
    # mixtral served and trained at full width, the reduced archs card vs
    # CPU
    torch.cuda.empty_cache()
    mixtral = phase11(dev, gen)

    # ---- 11b. mixtral served over a (data=1, model=2) mesh of two ranks
    # on the one card, each holding its chunks, against phase 11's run
    torch.cuda.empty_cache()
    sharded_serve_phase(mixtral.pop("sharded_ref"))

    # ---- 12. deepseek-v3-671b: reduced card vs CPU and the MoE's combine
    # bit for bit, served at full width, the cut trained, the NS kernels
    # at its buckets
    torch.cuda.empty_cache()
    deepseek = phase12(dev, gen)

    # ---- 13. qwen2-vl-7b and whisper-small: reduced card vs CPU, served
    # whole, decode vs the full forward, trained (qwen2-vl's cut, whisper
    # whole), the NS kernels at their buckets
    torch.cuda.empty_cache()
    vlm_audio = phase13(dev, gen)

    # ---- 14. recurrentgemma-2b and xlstm-1.3b: reduced card vs CPU,
    # served whole, decode vs the full forward, the cuts trained, the NS
    # kernels at their buckets
    torch.cuda.empty_cache()
    recurrent = phase14(dev, gen)

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
        r["resync_launches"] = resynced["launches"][r["name"]]
    for r in ns_rows + wire_rows:
        r["qwen_launches"] = dense["launches"][r["name"]]
        r["qwen_two_way_launches"] = dense["two_way_launches"][r["name"]]
    for r in ns_rows + wire_rows:
        r["mixtral_launches"] = mixtral["launches"][r["name"]]
        if mixtral["two_way_launches"] is not None:
            r["mixtral_two_way_launches"] = \
                mixtral["two_way_launches"][r["name"]]
        r["serving_launches"] = 0      # phases 11-14 fail on any
        r["deepseek_launches"] = deepseek["launches"][r["name"]]
        if deepseek["two_way_launches"] is not None:
            r["deepseek_two_way_launches"] = \
                deepseek["two_way_launches"][r["name"]]
        r["qwen2_vl_launches"] = vlm_audio["qwen_vl_launches"][r["name"]]
        r["whisper_launches"] = vlm_audio["whisper_launches"][r["name"]]
        r["griffin_launches"] = recurrent["griffin_launches"][r["name"]]
        r["xlstm_launches"] = recurrent["xlstm_launches"][r["name"]]
        # rank 0's of phase 9c's and 9d's three steps (every rank's alike)
        r["mesh_launches"] = meshed["ranks"][0]["launches"][r["name"]]
        r["pod_launches"] = podded["ranks"][0]["launches"][r["name"]]
        # rank 0's of 9s (a): 4 supervised steps and the abandoned attempt
        r["supervised_launches"] = ranked["supervised"]["ranks"][0][
            "raise"]["launches"][r["name"]]
    # the NS chain at each sketch shape of the rank paths; one iteration
    # at each of qwen's and mixtral's buckets
    ns_rows[0]["sketch_chains"] = sketch_rows
    ns_rows[0]["qwen_buckets"] = dense["ns_rows"]
    ns_rows[0]["mixtral_buckets"] = mixtral["ns_rows"]
    ns_rows[0]["deepseek_buckets"] = deepseek["ns_rows"]
    ns_rows[0]["qwen2_vl_whisper_buckets"] = vlm_audio["ns_rows"]
    ns_rows[0]["griffin_xlstm_buckets"] = recurrent["ns_rows"]
    ns_rows[0]["rank_split_chains"] = split_rows
    ns_rows[0]["mesh_chunk_chains"] = meshed["ranks"][0]["chains"]
    ns_rows[0]["pod_chunk_chains"] = podded["ranks"][0]["chains"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = ("design", "bound_ffma_ms", "effective_tflop_s",
             "executed_tflop_s", "flop_needed", "flop_executed",
             "fraction_of_bound", "tb_s", "in_step_ms", "copy_ms", "pad_ms",
             "chain_ms", "chain_eager_ms", "kept_outputs_ms",
             "body_launched_as", "body_launches", "two_way_launches",
             "rank10_launches", "rank10_two_way_launches", "gluon_launches",
             "fault_run_launches", "resync_launches", "sketch_chains",
             "qwen_launches", "qwen_two_way_launches", "qwen_buckets",
             "mixtral_launches", "mixtral_two_way_launches",
             "serving_launches", "mixtral_buckets", "deepseek_launches",
             "deepseek_two_way_launches", "deepseek_buckets",
             "qwen2_vl_launches", "whisper_launches",
             "qwen2_vl_whisper_buckets", "griffin_launches",
             "xlstm_launches", "griffin_xlstm_buckets",
             "rank_split_chains", "mesh_launches", "mesh_chunk_chains",
             "pod_launches", "pod_chunk_chains", "supervised_launches")
    emit({"kernels": [{k: r[k] for k in keys + extra if k in r}
                      for r in ns_rows + wire_rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
