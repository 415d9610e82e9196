"""Training CLI of the port (``repro.launch.train``'s flags, PyTorch).

    PYTHONPATH=src python -m repro_torch.launch.train --arch nanogpt-124m \
        --steps 4 --seq 1024 --batch 8 --workers 2 --w2s top10

Runs the EF21-Muon trainer on the synthetic Zipf-Markov stream and
prints the same header as the reference (params, analytic w2s bytes per
worker, the exact wire buffer and the two-way bytes, each beside its
share of dense, and the wire stage count) and the same JSON loss lines.
Like the reference's CLI it has no process group, so its step packs no
wire; ``setup`` and ``run_steps`` drive the same run with one.
``--device`` defaults to ``cuda``, where the kernels run; ``--device
cpu`` runs their plain versions. Flags of the reference that the port
does not run yet exit with an error naming the ROADMAP item.
"""
from __future__ import annotations

import argparse
import json
import math
import time

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.schedule import warmup_linear_decay
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.api import build_model
from repro_torch.train.trainer import Trainer, TrainerConfig

# reference flags outside this slice -> the ROADMAP item that ports them
NOT_PORTED = {
    "participation": "Queue 1 item 8 (elastic participation)",
    "faults": "Queue 1 item 8 (fault injection)",
    "resync": "Queue 1 item 8 (desynchronized-worker rejoin)",
    "supervise": "Queue 1 item 8 (the supervisor)",
    "metrics_out": "Queue 1 item 8 (metrics and the JSONL sink)",
    "trace_spans": "Queue 1 item 8 (trace spans)",
    "checkpoint": "Queue 1 item 6 (checkpoints)",
    "resume": "Queue 1 item 6 (checkpoints)",
    "donate": "Queue 1 item 6 (in-place state updates)",
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--beta", type=float, default=0.5)
    ap.add_argument("--w2s", default="top10")
    ap.add_argument("--s2w", default="identity")
    ap.add_argument("--radius", type=float, default=0.01)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "versions)")
    for flag in NOT_PORTED:
        opt = "--" + flag.replace("_", "-")
        if flag in ("supervise", "trace_spans", "donate"):
            ap.add_argument(opt, action="store_true", help=argparse.SUPPRESS)
        else:
            ap.add_argument(opt, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag, item in NOT_PORTED.items():
        val = getattr(args, flag)
        if val and not (flag == "participation" and val == "full") \
                and not (flag == "resync" and val == "0"):
            ap.error(f"--{flag.replace('_', '-')} is not ported to "
                     f"repro_torch yet: ROADMAP {item}")
    return args


def setup(args: argparse.Namespace, group=None) -> tuple:
    """(cfg, trainer, data, schedule) of the run ``args`` describe;
    ``group`` is the trainer's process group (the wire's all-gather)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeSpec("cli", "train", args.seq, args.batch)
    data = SyntheticLM(cfg, shape, n_workers=args.workers, seed=args.seed,
                       device=args.device)
    tcfg = TrainerConfig(n_workers=args.workers, beta=args.beta,
                         w2s=args.w2s, s2w=args.s2w)
    tr = Trainer(build_model(cfg), tcfg, device=args.device, group=group)
    return cfg, tr, data, warmup_linear_decay(args.radius, args.warmup,
                                              args.steps)


def run_steps(tr: Trainer, state: dict, data, sched, steps: int,
              log_every: int | None = None) -> dict:
    """``steps`` training steps from ``state`` (pass the only reference:
    each step replaces it); prints a JSON loss line
    every ``log_every`` steps (and the last), none when None. Returns
    {"losses", "step_s"} (per step, in order; ``step_s`` is host wall
    time of each step, ending with the loss read, which waits for the
    device)."""
    step_fn = tr.make_step()
    losses, step_s = [], []
    t0 = time.time()
    for i in range(steps):
        ts = time.perf_counter()
        state, aux = step_fn(state, data.batch_at(i), sched(i))
        loss = float(aux["loss"])
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(json.dumps({"step": i, "loss": round(loss, 4),
                              "radius": round(float(sched(i)), 5),
                              "wall_s": round(time.time() - t0, 1)}),
                  flush=True)
    return {"losses": losses, "step_s": step_s}


def main(argv=None) -> dict:
    """Train and print; returns what ``run_steps`` returns."""
    args = parse_args(argv)
    cfg, tr, data, sched = setup(args)
    plan = tr.layer_plan()
    dt = tr.opt.cfg.wire_dtype
    n_params = sum(math.prod(lp.shape) for lp in plan.leaves)
    wire = plan.w2s_bytes_per_worker(dt)
    dense = plan.dense_bytes(dt)
    buf = plan.wire_layout(dt).total_nbytes
    stages = plan.stage_plan(wire_stages=tr.opt.cfg.wire_stages).n_stages
    print(f"arch={cfg.name} params={n_params} "
          f"w2s_bytes/worker={wire} ({wire / dense:.3f} of dense) "
          f"wire_buffer={buf} ({buf / dense:.3f} of dense) "
          f"s2w_bytes/round=0 s2w_wire_buffer=0 two_way_wire={buf} "
          f"wire_stages={stages} device={tr.device}", flush=True)
    # no reference to the initial state stays here: run_steps drops it
    return run_steps(tr, tr.init(args.seed), data, sched, args.steps,
                     args.log_every)


if __name__ == "__main__":
    main()
