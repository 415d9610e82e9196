"""Training CLI of the port (``repro.launch.train``'s flags, PyTorch).

    PYTHONPATH=src python -m repro_torch.launch.train --arch nanogpt-124m \
        --steps 4 --seq 1024 --batch 8 --workers 2 --w2s top10

``--w2s`` and ``--s2w`` take every name of the compressor registry
(``core/compressors.py``: identity, natural, top5..top20, rank5..rank20
and their ``+natural`` combinations).

Runs the EF21-Muon trainer on the synthetic Zipf-Markov stream and
prints the same header as the reference (params, analytic w2s bytes per
worker and the exact wire buffer, each beside its share of dense, the
analytic s2w bytes per round and the exact s2w buffer, the two-way
bytes, and the wire stage count) and the same JSON loss lines (with
``n_participants`` when participation is elastic). Like the reference's
CLI it has no process group, so its step packs neither wire (``--s2w``
runs the unpacked EF21-P leg); ``setup`` and ``run_steps`` drive the
same run with one.

The reference's run-time flags: ``--checkpoint``/``--resume`` (and
``--checkpoint-every`` under the supervisor), ``--donate``,
``--metrics-out`` (the JSONL sink, with in-step metrics) and
``--trace-spans``, ``--participation``/``--participation-seed``,
``--faults`` (``train/faults.py``'s grammar; ``crash`` exits with
``CRASH_EXIT``) and ``--supervise`` (``--step-timeout``,
``--max-retries``) and ``--resync R`` (the desynchronized-worker rejoin:
per-worker W estimates and an R-deep replay ring of s2w rounds; the
``RESYNC_SUMMARY`` line counts its replays, full copies and last lag).
``--device`` defaults to ``cuda``, where the kernels run; ``--device
cpu`` runs their plain versions.
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
from repro_torch.obs.sink import MetricsWriter, run_manifest
from repro_torch.obs.trace import span_summary
from repro_torch.train.checkpoint import (load_checkpoint, save_checkpoint,
                                          state_template)
from repro_torch.train.faults import parse_faults
from repro_torch.train.supervisor import Supervisor, SupervisorConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


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
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write schema-versioned JSONL metrics here "
                         "(implies in-step metrics collection, §10)")
    ap.add_argument("--trace-spans", action="store_true",
                    help="record_function/NVTX ranges around the step's "
                         "phases and wire stages")
    ap.add_argument("--participation", default="full", metavar="SPEC",
                    help="elastic worker participation (§11): 'full', "
                         "'bernoulli(p)' or 'round_robin(k)'")
    ap.add_argument("--participation-seed", type=int, default=0)
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="chaos schedule, e.g. "
                         "'drop:w=1:steps=5-10,nan:w=0:steps=7,"
                         "flip:steps=4:bits=8' (repro_torch.train.faults)")
    ap.add_argument("--donate", action="store_true",
                    help="update the optimizer state in place (no second "
                         "copy of the state during a step)")
    ap.add_argument("--resync", type=int, default=0, metavar="R",
                    help="desynchronized-worker rejoin (§13): keep "
                         "per-worker W estimates + an R-deep replay ring "
                         "of packed s2w rounds; 0 turns it off. "
                         "Requires a compressing --s2w")
    ap.add_argument("--supervise", action="store_true",
                    help="run the loop under the §13 supervisor "
                         "(per-step timeout, bounded retry, checkpoint-"
                         "reload recovery)")
    ap.add_argument("--step-timeout", type=float, default=None,
                    metavar="SEC", help="supervisor per-step watchdog")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="supervisor re-dispatches per step")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    metavar="N", help="periodic last-good checkpoint to "
                         "--checkpoint every N steps (supervisor "
                         "recovery granularity)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    if args.supervise and args.donate:
        print("warning: --supervise needs the input state intact for "
              "retries; disabling --donate")
        args.donate = False
    return args


def setup(args: argparse.Namespace, group=None, cfg=None) -> tuple:
    """(cfg, trainer, data, schedule) of the run ``args`` describe;
    ``group`` is the trainer's process group (the wire's collectives and
    the worker axis: each rank runs its share of ``--workers`` on its
    rows of the batch). ``cfg`` replaces the config ``--arch`` and
    ``--reduced`` name (a depth-scaled one, ``with_depth``)."""
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    shape = ShapeSpec("cli", "train", args.seq, args.batch)
    faults = (parse_faults(args.faults, args.workers, seed=args.seed)
              if args.faults else None)
    tcfg = TrainerConfig(
        n_workers=args.workers, beta=args.beta, w2s=args.w2s, s2w=args.s2w,
        metrics=args.metrics_out is not None, trace_spans=args.trace_spans,
        participation=args.participation,
        participation_seed=args.participation_seed, faults=faults,
        donate=args.donate, resync=args.resync)
    tr = Trainer(build_model(cfg), tcfg, device=args.device, group=group)
    data = SyntheticLM(cfg, shape, n_workers=args.workers, seed=args.seed,
                       device=str(tr.device), group=group)
    return cfg, tr, data, warmup_linear_decay(args.radius, args.warmup,
                                              args.steps)


def run_steps(tr: Trainer, state: dict, data, sched, steps: int,
              log_every: int | None = None, *, start: int = 0,
              sup: Supervisor | None = None, writer=None) -> dict:
    """Training steps ``start`` .. ``steps - 1`` from ``state`` (pass the
    only reference: each step replaces it); prints a JSON loss line
    every ``log_every`` steps (and the last), none when None, and writes
    it, with the step's metrics, to ``writer``. Under ``sup`` each step
    is supervised (its stall faults slept inside the watched call) and
    periodically checkpointed, and a reload rewinds the loop. A
    ``crash`` fault of ``tr``'s plan exits the process at its step on a
    run that started at 0. Returns {"losses", "step_s", "n_participants",
    "lags", "resync_replayed", "resync_full", "version_lag_max",
    "metrics", "state", "aux"}: per step run, in order (``step_s`` is the
    host wall time of each step, ending with the loss read, which waits
    for the device; ``n_participants`` is empty unless participation is
    elastic, ``lags`` each step's ``version_lag_max`` and empty unless
    resync is on), the replays and full copies summed and the last lag,
    the host metrics of the last line written, then the last state and
    aux."""
    faults = tr.tcfg.faults
    step_fn = tr.make_step()
    losses, step_s, n_part, lags = [], [], [], []
    replayed = full = 0
    aux: dict = {"loss": float("nan")}
    metrics: dict = {}
    t0 = time.time()
    i = start
    while i < steps:
        if faults is not None:
            # simulated power loss (crash:step=s): fresh runs only, so
            # the --resume run sails past the crash step
            faults.host_crash(i, start_step=start)
        ts = time.perf_counter()
        if sup is not None:
            result, rs_state, rs_step = sup.run_step(
                step_fn, state, data.batch_at(i), sched(i), step=i,
                faults=faults)
            if result is None:
                # checkpoint-reload recovery: rewind to the last-good
                # generation and step again from there
                state, i = rs_state, rs_step
                print(f"recovered from {sup.cfg.checkpoint_path} "
                      f"@ step {i}", flush=True)
                continue
            state, aux = result
        else:
            state, aux = step_fn(state, data.batch_at(i), sched(i))
        loss = float(aux["loss"])
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if "n_participants" in aux:
            n_part.append(int(aux["n_participants"]))
        if "resync_replayed" in aux:
            replayed += int(aux["resync_replayed"])
            full += int(aux["resync_full"])
            lags.append(int(aux["version_lag_max"]))
        if sup is not None:
            sup.maybe_checkpoint(state, i)
        if log_every and (i % log_every == 0 or i == steps - 1):
            row = {"step": i, "loss": round(loss, 4),
                   "radius": round(float(sched(i)), 5),
                   "wall_s": round(time.time() - t0, 1)}
            if n_part:
                row["n_participants"] = n_part[-1]
            print(json.dumps(row), flush=True)
            if writer is not None:
                metrics = aux["metrics"].host_floats()
                if sup is not None:
                    metrics["supervisor/retries"] = float(sup.retries)
                writer.write("step", metrics=metrics, **row)
        i += 1
    return {"losses": losses, "step_s": step_s, "n_participants": n_part,
            "lags": lags, "resync_replayed": replayed, "resync_full": full,
            "version_lag_max": lags[-1] if lags else 0,
            "metrics": metrics, "state": state, "aux": aux}


def _ef_summary_rows(metrics: dict, limit: int = 12) -> list[dict]:
    """Per-layer EF21 error rows from one step's metric dict, largest
    ``ef/err_norm`` first (the layers where compression bites hardest)."""
    rows = []
    for name, v in metrics.items():
        if not name.startswith("ef/err_norm/"):
            continue
        leaf = name[len("ef/err_norm/"):]
        rows.append({
            "leaf": leaf, "err_norm": v,
            "rel_err": metrics.get(f"ef/rel_err/{leaf}"),
            "momentum_norm": metrics.get(f"ef/momentum_norm/{leaf}"),
        })
    rows.sort(key=lambda r: -(r["err_norm"] or 0.0))
    return rows[:limit]


def _print_tables(spans: list[dict], ef_rows: list[dict]) -> None:
    if spans:
        print("-- host phase timings --")
        print(f"{'span':32s} {'count':>6s} {'total_s':>9s} {'max_s':>9s}")
        for r in spans:
            print(f"{r['name']:32s} {r['count']:6d} "
                  f"{r['total_s']:9.4f} {r['max_s']:9.4f}")
    if ef_rows:
        print("-- EF21 error by layer (final step, worst first) --")
        print(f"{'leaf':28s} {'err_norm':>10s} {'rel_err':>8s} "
              f"{'momentum':>10s}")
        for r in ef_rows:
            rel = r["rel_err"]
            mom = r["momentum_norm"]
            print(f"{r['leaf']:28s} {r['err_norm']:10.4g} "
                  f"{(f'{rel:8.3f}' if rel is not None else '       -')} "
                  f"{(f'{mom:10.4g}' if mom is not None else '         -')}")


def main(argv=None) -> dict:
    """Train and print; returns {"losses", "step_s", "summary"}: per step
    run, and the ``RESYNC_SUMMARY`` line's fields."""
    args = parse_args(argv)
    cfg, tr, data, sched = setup(args)
    plan = tr.layer_plan()
    dt = tr.opt.cfg.wire_dtype
    n_params = sum(math.prod(lp.shape) for lp in plan.leaves)
    wire = plan.w2s_bytes_per_worker(dt)
    dense = plan.dense_bytes(dt)
    buf = plan.wire_layout(dt).total_nbytes
    two_way = args.s2w != "identity"
    s2w_wire = plan.s2w_bytes_per_round(dt) if two_way else 0
    s2w_buf = plan.wire_layout(dt, "s2w").total_nbytes if two_way else 0
    stages = plan.stage_plan(wire_stages=tr.opt.cfg.wire_stages).n_stages
    state = tr.init(args.seed)
    start = 0
    if args.resume:
        like = state_template(state)
        del state       # no second copy of the state while loading
        state, start = load_checkpoint(args.resume, like)
        start = start or 0
        print(f"resumed from {args.resume} @ step {start}")
    print(f"arch={cfg.name} params={n_params} "
          f"w2s_bytes/worker={wire} ({wire / dense:.3f} of dense) "
          f"wire_buffer={buf} ({buf / dense:.3f} of dense) "
          f"s2w_bytes/round={s2w_wire} s2w_wire_buffer={s2w_buf} "
          f"two_way_wire={buf + s2w_buf} "
          f"wire_stages={stages} device={tr.device}", flush=True)
    writer = None
    if args.metrics_out:
        writer = MetricsWriter(args.metrics_out, manifest=run_manifest(
            tr.tcfg, None, extra={"arch": cfg.name}))
    sup = None
    if args.supervise:
        sup = Supervisor(SupervisorConfig(
            step_timeout_s=args.step_timeout, max_retries=args.max_retries,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every),
            writer=writer, state_like=state_template(state))
        if writer is not None:
            writer.write("recovery", step=start, event="resume" if
                         args.resume else "start", attempt=0)
    box = [state]
    del state
    try:
        # no reference to the state stays here: run_steps drops each one
        out = run_steps(tr, box.pop(), data, sched, args.steps,
                        args.log_every, start=start, sup=sup, writer=writer)
        if args.checkpoint:
            save_checkpoint(args.checkpoint, out["state"], step=args.steps)
            print(f"saved {args.checkpoint}")
        del out["state"]
        spans = span_summary()
        ef_rows = _ef_summary_rows(out["metrics"])
        _print_tables(spans, ef_rows)
        summary = {"final_loss": round(float(out["aux"]["loss"]), 4),
                   "resync_replayed": out["resync_replayed"],
                   "resync_full": out["resync_full"],
                   "version_lag_max": out["version_lag_max"],
                   "supervisor_retries": sup.retries if sup else 0,
                   "supervisor_reloads": sup.reloads if sup else 0}
        # one greppable line, the reference's
        print("RESYNC_SUMMARY " + json.dumps(summary), flush=True)
        if writer is not None:
            for r in spans:
                writer.write("span", **r)
            writer.write("summary", spans=spans, ef_summary=ef_rows,
                         **summary)
    finally:
        if writer is not None:
            writer.close()
            print(f"metrics written to {args.metrics_out}")
    return {"losses": out["losses"], "step_s": out["step_s"],
            "summary": summary}


if __name__ == "__main__":
    main()
