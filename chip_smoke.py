#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the repository around this file; exits non-zero
without printing a result otherwise. In order, any failure ending the run:

  1. prints the card's name and power limit as ``nvidia-smi`` gives them;
  2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, timed;
  3. holds each kernel against its plain PyTorch version on the card, at
     the shapes of nanogpt-124m's two Newton-Schulz buckets ([48,768,768]
     and [24,768,3072]) plus ragged ones, with the tolerances below, and
     times kernel, plain version and a cuBLAS yardstick with CUDA events;
  4. drives the port's train CLI on nanogpt-124m at full width (12
     layers, d_model 768) for 4 steps on the card — 2 workers, top10
     w2s, seq 1024, batch 8 — and checks that the losses are finite and
     that the Newton-Schulz kernels were launched exactly steps x ns_steps
     x buckets x 3 times; before that, a reduced nanogpt run on the card
     must track the same run on the CPU (plain versions);
  5. prints one JSON line of per-kernel numbers, then, as the last line,
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
F32_FLOPS = 67e12        # f32 outside the tensor cores: the kernels' FFMA
HBM_BYTES_S = 3.35e12

# Tolerances, as max|kernel - plain| / max|plain| on the card. Both sides
# are true f32 with f32 accumulation; they differ only in summation order
# over K <= 3072 terms (f32 eps 1.2e-7; a worst-case bound is ~K eps).
TOL_ONE_PASS = 1e-5      # one GEMM / one NS iteration
TOL_NS_CHAIN = 1e-4      # 5 chained NS iterations amplify the difference
TOL_SLICE_LOSS = 1e-3    # reduced nanogpt, 3 steps, card vs CPU (abs)

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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_op, t_b = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.newton_schulz import (LAUNCHES, TILE,
                                                   fused_matmul,
                                                   ns_iteration,
                                                   reset_launches)
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
    randn = lambda *s: torch.randn(s, device=dev, generator=gen)
    a_, b_, c_ = ref.NS_COEFFS

    def normalised(*s):
        x = randn(*s)
        return x / x.flatten(1).norm(dim=1)[:, None, None]

    buckets = [normalised(48, 768, 768), normalised(24, 768, 3072)]
    err_ns = max(check(f"ns_iteration{list(x.shape)}", ns_iteration(x),
                       ref.ns_iteration_batched_ref(x), TOL_ONE_PASS)
                 for x in buckets + [normalised(3, 200, 328)])
    err_ns = max(err_ns, *(
        check(f"newton_schulz_batched{list(x.shape)}x{NS_STEPS}",
              ops.newton_schulz_batched(x, steps=NS_STEPS),
              ref.newton_schulz_batched_ref(x, steps=NS_STEPS),
              TOL_NS_CHAIN) for x in buckets))

    # fused_matmul as one NS iteration calls it (poly: G@G + C, update:
    # P@X + C), then without C, transposed, ragged
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
                 False)]
    err_mm = 0.0
    for A, B, C, al, be, tb in mm_main + mm_extra:
        err_mm = max(err_mm, check(
            f"fused_matmul{list(A.shape)}x{list(B.shape)}"
            f"{'^T' if tb else ''}{'+C' if C is not None else ''}",
            fused_matmul(A, B, C, alpha=al, beta=be, trans_b=tb),
            ref.fused_matmul_ref(A, B.mT if tb else B, C, al, be),
            TOL_ONE_PASS))

    # times over one NS iteration of both buckets
    def ns_library(x):
        g = torch.bmm(x, x.mT)
        return torch.baddbmm(x, torch.baddbmm(g, g, g, beta=b_, alpha=c_),
                             x, beta=a_)

    ns_row = {"name": "ns_iteration", "route": "cuda",
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
    # FLOP the iteration needs per [m, n] slice: the gram XX^T and the
    # poly's A^2 are symmetric, so each needs only its m(m+1)/2 upper dot
    # products (lengths n and m); the update PX is a full GEMM. The kernels
    # execute more: the diagonal gram tiles in full, and all of A^2.
    def ns_flop(x, executed: bool) -> int:
        bsz, m, n = x.shape
        t = -(-m // TILE)
        gram = t * (t + 1) * TILE ** 2 * n if executed else m * (m + 1) * n
        poly = 2 * m ** 3 if executed else m * (m + 1) * m
        return bsz * (gram + poly + 2 * m * m * n)

    flop_needed = sum(ns_flop(x, False) for x in buckets)
    flop_executed = sum(ns_flop(x, True) for x in buckets)
    emit({"ns_iteration_flop": {"needed": flop_needed,
                                "executed": flop_executed,
                                "executed_tflop_s":
                                    flop_executed / ns_row["ms"] / 1e9}})
    ns_row["bound_ms"], ns_row["bound_by"] = bound_ms(
        flop_needed, sum(2 * 4 * x.numel() for x in buckets))

    mm_row = {"name": "fused_matmul", "route": "cuda",
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
    nbytes = sum(4 * (a.numel() + b.numel() + 2 * c.numel())
                 for a, b, c, *_ in mm_main)
    mm_row["bound_ms"], mm_row["bound_by"] = bound_ms(flops, nbytes)
    del buckets, mm_main, mm_extra
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
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("nanogpt-124m")
    n_buckets = len(Trainer(build_model(cfg), TrainerConfig(
        n_workers=2, w2s="top10"), device=dev).layer_plan().ns_buckets())
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
    if launches["ns_iteration"] != iters \
            or launches["fused_matmul"] != 2 * iters:
        fail(f"NS launches {launches}, expected {iters} ns_iteration and "
             f"{2 * iters} fused_matmul ({LAUNCHES_PER_ITERATION * iters} "
             "kernel launches)")

    ns_row["launches"] = launches["ns_iteration"]
    mm_row["launches"] = launches["fused_matmul"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [{k: r[k] for k in keys} for r in (ns_row, mm_row)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
