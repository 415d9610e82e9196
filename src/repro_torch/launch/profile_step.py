"""Profile of nanogpt-124m's one-way and two-way steps on one card.

    PYTHONPATH=src python -m repro_torch.launch.profile_step [--steps 4]

Runs the packed one-way step (``--w2s top10+natural``) and the packed
two-way step (the same with ``--s2w natural``) at full width (seq 1024,
batch 8, 2 workers) through a Trainer over a one-rank NCCL group, with
the trace spans on, alternated: one-way, two-way, two-way, one-way. Each
run takes 2 warm-up steps, ``--steps`` steady steps timed by the host
clock (each ending in a synchronise) and one more under
``torch.profiler``. Per profiled step it reports the wall time, the
device's busy time (the sum of the card's kernel and copy times, one
stream's work at a time), their ratio, the device ms of each phase span
(``obs.trace.PHASE_SPANS``) and wire stage span (``span_device_ms``),
the host's PyTorch operations and kernel launches, and the kernels that
take the most device time; then the two-way minus one-way differences of
the medians. Prints the card's name and power limit, then one JSON line.
Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.launch import train as train_cli
from repro_torch.obs.trace import PHASE_SPANS, RESYNC_SPAN, wire_stage_span

ONE_WAY = ["--arch", "nanogpt-124m", "--seq", "1024", "--batch", "8",
           "--workers", "2", "--w2s", "top10+natural", "--s2w", "identity",
           "--beta", "0.5", "--device", "cuda", "--trace-spans"]
TWO_WAY = [a if a != "identity" else "natural" for a in ONE_WAY]
WARMUP = 2


def _median(xs: list) -> float:
    return sorted(xs)[len(xs) // 2]


def span_names(n_stages: int = 8) -> tuple[str, ...]:
    """The phase spans, the resync replay's and the wire stage spans of
    up to ``n_stages``."""
    return PHASE_SPANS + (RESYNC_SPAN,) + tuple(
        wire_stage_span(d, k) for d in ("s2w", "w2s")
        for k in range(n_stages))


def device_busy_ms(events) -> float:
    """The card's kernel and copy time in a capture's events (the device
    ranges that mirror ``record_function`` spans left out)."""
    from torch.autograd import DeviceType
    names = span_names()
    return sum(e.time_range.elapsed_us() for e in events
               if e.device_type == DeviceType.CUDA and e.name not in names
               and not getattr(e, "is_user_annotation", False)) / 1e3


def span_device_ms(events, names=None) -> tuple[dict[str, float], float]:
    """Device ms of the work launched inside each span of ``names``
    (default ``span_names()``) in a ``torch.profiler`` capture's events,
    and the device ms whose launch the capture does not show. Each
    kernel, copy or memset on the card is matched by its correlation id
    to the host's runtime call that launched it (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...: from any thread, the
    backward's included, and from the ctypes wrappers of the port's own
    kernels, which no PyTorch op encloses), and counts toward every span
    whose host interval holds that call's start. Nested spans both count
    (a stage span inside phase 4)."""
    from torch.autograd import DeviceType
    names = span_names() if names is None else names
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
             if e.name in names]
    launched = {e.id: e.time_range.start for e in cpu
                if e.name.startswith(("cuda", "cu")) and e.id > 0}
    out = {n: 0.0 for n in names}
    unlaunched = 0.0
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in names \
                or getattr(e, "is_user_annotation", False):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        t = launched.get(e.id)
        if t is None:
            unlaunched += ms
            continue
        for a, b, n in spans:
            if a <= t <= b:
                out[n] += ms
    return {n: v for n, v in out.items() if v or n in PHASE_SPANS}, \
        unlaunched


def _profiled(prof, wall: float) -> dict:
    """The numbers of one profiled step."""
    from torch.autograd import DeviceType
    rows = prof.key_averages()
    events = prof.events()
    on_card = [e for e in rows if e.device_type == DeviceType.CUDA
               and e.key not in span_names()]
    busy = device_busy_ms(events) / 1e3
    spans, unlaunched = span_device_ms(events)
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)
    return {"wall_s": wall, "device_busy_s": busy, "busy_share": busy / wall,
            "span_device_ms": spans,
            "phases_share_of_busy": sum(spans[n] for n in PHASE_SPANS)
            / (busy * 1e3),
            "device_ms_without_a_launch_record": unlaunched,
            "torch_ops": sum(e.count for e in rows
                             if e.key.startswith("aten::")),
            "launches": sum(e.count for e in rows if e.key in (
                "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")),
            "top_kernels_ms": [(e.key[:60], e.self_device_time_total / 1e3,
                                e.count) for e in top[:8]]}


def breakdown(group, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    arms = {"one_way": ONE_WAY, "two_way": TWO_WAY}
    out = {arm: {"steady_step_s": [], "profiled": []} for arm in arms}
    for arm in ("one_way", "two_way", "two_way", "one_way"):
        _, tr, data, sched = train_cli.setup(
            train_cli.parse_args(arms[arm]), group=group)
        step, state = tr.make_step(), tr.init(0)
        for i in range(WARMUP + steps + 1):
            profiled = i == WARMUP + steps
            if profiled:
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, aux = step(state, data.batch_at(i), sched(i))
            float(aux["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if profiled:
                prof.stop()
                out[arm]["profiled"].append(_profiled(prof, wall))
            elif i >= WARMUP:
                out[arm]["steady_step_s"].append(wall)
        del step, state, tr
        torch.cuda.empty_cache()
    diff = {k: _median([r[k] for r in out["two_way"]["profiled"]])
            - _median([r[k] for r in out["one_way"]["profiled"]])
            for k in ("wall_s", "device_busy_s", "torch_ops", "launches")}
    diff["steady_step_s"] = _median(out["two_way"]["steady_step_s"]) \
        - _median(out["one_way"]["steady_step_s"])
    return {"step_breakdown": out, "two_way_minus_one_way_medians": diff}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.profile_step")
    ap.add_argument("--steps", type=int, default=4,
                    help="steady steps timed per run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_step: needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        out = breakdown(dist.group.WORLD, args.steps)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
