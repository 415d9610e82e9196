"""The port's supervisor, host-side fault clauses and train CLI flags
against the reference's (DESIGN.md §13).

The reference's fault-grammar and supervisor cases
(``tests/test_resync.py``) on the port's ``parse_faults`` and
``Supervisor``; a reload from the port's checkpoint; the CLI's crash ->
resume in a subprocess on the CPU, ending at the uninterrupted run's
loss; the CLI accepting every flag of ``repro.launch.train``,
``--resync N`` included; the ``--supervise --donate`` warning.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.launch import train as train_cli
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.faults import (CRASH_EXIT, CrashFault, StallFault,
                                      parse_faults)
from repro_torch.train.supervisor import (Supervisor, SupervisorConfig,
                                          SupervisorError)
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--arch", "nanogpt-124m", "--reduced", "--steps", "4", "--seq",
         "16", "--batch", "2", "--workers", "2", "--log-every", "1",
         "--device", "cpu"]


# ---------------------------------------------------- the fault grammar

def test_parse_stall_round_trip():
    fp = parse_faults("stall:w=1:steps=5-7:ms=250", n_workers=4)
    assert fp.stalls == (StallFault(1, 5, 7, ms=250),)
    assert fp.stall_ms(5) == 250 and fp.stall_ms(7) == 0
    assert fp.stall_ms(5, attempt=1) == 0     # retries skip the stall
    assert fp.active_any(6) and not fp.active_any(8)


def test_parse_stall_default_ms():
    fp = parse_faults("stall:w=0:steps=3", n_workers=2)
    assert fp.stalls[0].ms == 1000
    assert fp.stalls[0].start == 3 and fp.stalls[0].stop == 4


def test_parse_crash_round_trip():
    fp = parse_faults("crash:step=9", n_workers=2)
    assert fp.crashes == (CrashFault(9),)
    assert fp.crashes[0].start == 9 and fp.crashes[0].stop == 10
    assert fp.active_any(9) and not fp.active_any(10)


def test_parse_mixed_clauses_with_host_faults():
    fp = parse_faults(
        "drop:w=1:steps=2-4,stall:w=0:steps=5:ms=50,crash:step=8",
        n_workers=3)
    assert len(fp.drops) == 1 and len(fp.stalls) == 1
    assert len(fp.crashes) == 1


@pytest.mark.parametrize("bad", [
    "stall:w=9:steps=1:ms=5",   # worker out of range
    "stall:w=0:steps=1:ms=0",   # non-positive stall
    "crash:steps=3",            # crash takes step=, not steps=
    "stall:w=0",                # missing steps
])
def test_parse_host_faults_reject(bad):
    with pytest.raises(ValueError):
        parse_faults(bad, n_workers=4)


def test_host_crash_gated_on_resumed_runs():
    fp = parse_faults("crash:step=4", n_workers=2)
    fp.host_crash(4, start_step=2)   # resumed run: must NOT exit
    fp.host_crash(3, start_step=0)   # wrong step: no exit
    assert CRASH_EXIT == 43


def test_host_stall_sleeps_and_reports(monkeypatch):
    import repro_torch.train.faults as faults_mod
    slept = []
    monkeypatch.setattr(faults_mod.time, "sleep",
                        lambda s: slept.append(s))
    fp = parse_faults("stall:w=0:steps=2:ms=80", n_workers=1)
    assert fp.host_stall(2) == 80 and slept == [0.08]
    assert fp.host_stall(2, attempt=1) == 0 and len(slept) == 1


# ---------------------------------------------------------- supervisor

class _ListWriter:
    def __init__(self):
        self.records = []

    def write(self, rec_kind, **fields):
        self.records.append({"rec_kind": rec_kind, **fields})


def test_supervisor_passthrough_without_watchdog():
    sup = Supervisor(SupervisorConfig())
    result, rs, rstep = sup.run_step(lambda s, b: (s + b, {}), 1, 2,
                                     step=0)
    assert result == (3, {}) and rs is None and rstep is None
    assert sup.retries == 0


def test_supervisor_timeout_then_retry_succeeds():
    fp = parse_faults("stall:w=0:steps=5:ms=10000", n_workers=1)
    w = _ListWriter()
    sup = Supervisor(SupervisorConfig(step_timeout_s=0.1, max_retries=2,
                                      backoff_base_s=0.01), writer=w)
    result, rs, rstep = sup.run_step(lambda s: s * 2, 21, step=5,
                                     faults=fp)
    assert result == 42 and rs is None and rstep is None
    assert sup.retries == 1
    assert [r["event"] for r in w.records] == ["timeout"]
    assert all(r["rec_kind"] == "recovery" for r in w.records)
    assert w.records[0]["step"] == 5 and w.records[0]["attempt"] == 0


def test_supervisor_transient_exception_retries():
    attempts = []

    def flaky(state):
        attempts.append(1)
        if len(attempts) < 3:
            raise RuntimeError("transient")
        return state

    sup = Supervisor(SupervisorConfig(max_retries=3, backoff_base_s=0.0))
    result, _, _ = sup.run_step(flaky, "ok", step=1)
    assert result == "ok" and sup.retries == 2


def test_supervisor_exhaustion_raises():
    w = _ListWriter()
    sup = Supervisor(SupervisorConfig(max_retries=1, backoff_base_s=0.0),
                     writer=w)
    with pytest.raises(SupervisorError, match="after 2 attempt"):
        sup.run_step(lambda s: 1 / 0, None, step=3)
    assert [r["event"] for r in w.records] == ["retry", "retry",
                                               "gave_up"]


def test_supervisor_reloads_last_good_checkpoint(tmp_path):
    """The port's checkpoint, reloaded after every retry failed."""
    path = str(tmp_path / "ck")
    good = {"x": np.arange(4.0, dtype=np.float32)}
    save_checkpoint(path, good, step=6)
    w = _ListWriter()
    sup = Supervisor(
        SupervisorConfig(max_retries=0, checkpoint_path=path),
        writer=w, state_like={"x": np.zeros(4, np.float32)})

    def bad(state):
        raise RuntimeError("device poisoned")

    result, rs_state, rs_step = sup.run_step(bad, None, step=9)
    assert result is None and rs_step == 6
    np.testing.assert_allclose(np.asarray(rs_state["x"]), good["x"])
    assert sup.reloads == 1
    assert [r["event"] for r in w.records] == ["retry", "reload"]
    with pytest.raises(SupervisorError):
        sup.run_step(bad, None, step=9)


def test_supervisor_maybe_checkpoint_cadence(tmp_path):
    path = str(tmp_path / "ck")
    sup = Supervisor(SupervisorConfig(checkpoint_path=path,
                                      checkpoint_every=4))
    assert not sup.maybe_checkpoint({"x": np.zeros(2)}, 0)
    assert sup.maybe_checkpoint({"x": np.ones(2)}, 3)    # (3+1) % 4 == 0
    tree, step = load_checkpoint(path, {"x": np.zeros(2, np.float32)})
    assert step == 4 and np.asarray(tree["x"]).tolist() == [1.0, 1.0]


def test_supervisor_config_validation():
    with pytest.raises(ValueError):
        SupervisorConfig(max_retries=-1)
    with pytest.raises(ValueError):
        SupervisorConfig(step_timeout_s=0.0)


def test_supervised_cli_reloads_after_a_failing_step(tmp_path, capsys,
                                                     monkeypatch):
    """Reduced nanogpt under --supervise with a checkpoint every step:
    a step that raises on every attempt reloads the last-good
    generation and the loop steps again from there, to the plain run's
    losses."""
    plain = train_cli.main(SMALL)["losses"]
    capsys.readouterr()
    path = str(tmp_path / "ck")
    real = train_cli.Trainer.make_step
    failed = []

    def make_step(self):
        step = real(self)

        def flaky(state, batch, t):
            if int(state["step"]) == 2 and len(failed) < 2:
                failed.append(1)
                raise RuntimeError("device lost")
            return step(state, batch, t)
        return flaky

    monkeypatch.setattr(train_cli.Trainer, "make_step", make_step)
    out = train_cli.main(SMALL + ["--supervise", "--max-retries", "1",
                                  "--checkpoint", path,
                                  "--checkpoint-every", "1"])
    text = capsys.readouterr().out
    assert f"recovered from {path} @ step 2" in text
    summary = json.loads(text.split("RESYNC_SUMMARY ")[1].splitlines()[0])
    assert summary["supervisor_retries"] == 1
    assert summary["supervisor_reloads"] == 1
    assert out["losses"] == plain


# ---------------------------------------------------------------- CLI

def test_cli_crash_then_resume_in_a_subprocess(tmp_path):
    """--supervise with a periodic checkpoint and a crash fault: the
    process exits with CRASH_EXIT at the step; --resume runs the rest,
    to the uninterrupted run's losses."""
    path = str(tmp_path / "ck")
    # one thread each: the subprocesses share the CPU with the test run
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    argv = [sys.executable, "-m", "repro_torch.launch.train", *SMALL,
            "--supervise", "--checkpoint", path, "--checkpoint-every", "1",
            "--faults", "crash:step=2"]
    r = subprocess.run(argv, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == CRASH_EXIT, r.stderr[-2000:]
    r2 = subprocess.run(argv + ["--resume", path], env=env,
                        capture_output=True, text=True, timeout=300)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert f"resumed from {path} @ step 2" in r2.stdout
    resumed = [json.loads(x)["loss"] for x in r2.stdout.splitlines()
               if x.startswith('{"step"')]
    full = train_cli.main(SMALL)["losses"]
    assert resumed == [round(v, 4) for v in full[2:]]


def _reference_flags() -> list[str]:
    src = (ROOT / "src" / "repro" / "launch" / "train.py").read_text()
    return re.findall(r'ap\.add_argument\("(--[a-z-]+)"', src)


VALUES = {"--arch": "nanogpt-124m", "--participation": "round_robin(1)",
          "--faults": "drop:w=1:steps=1-2", "--metrics-out": "m.jsonl",
          "--w2s": "top10", "--s2w": "natural", "--checkpoint": "c",
          "--resume": "c", "--step-timeout": "2.5", "--beta": "0.5",
          "--radius": "0.01"}
STORE_TRUE = ("--reduced", "--trace-spans", "--donate", "--supervise")


def test_cli_accepts_every_reference_flag_but_resync(capsys):
    flags = _reference_flags()
    assert len(flags) == 24 and "--resync" in flags
    argv = ["--arch", "nanogpt-124m"]
    for flag in flags:
        if flag in ("--arch",):
            continue
        if flag in STORE_TRUE:
            argv.append(flag)
        else:
            argv += [flag, VALUES.get(flag, "0" if flag == "--resync"
                                      else "3")]
    args = train_cli.parse_args(argv)
    assert args.resync == 0 and args.participation == "round_robin(1)"
    # --resync N > 0 too, since the rejoin slice: the flag parses, and
    # its error (an identity s2w leg) is the reference's, from the step
    args = train_cli.parse_args(["--arch", "nanogpt-124m", "--resync", "2",
                                 "--s2w", "natural"])
    assert args.resync == 2 and capsys.readouterr().err == ""


def test_supervise_drops_donate_with_the_reference_warning(capsys):
    args = train_cli.parse_args(["--arch", "nanogpt-124m", "--supervise",
                                 "--donate"])
    assert args.supervise and not args.donate
    assert capsys.readouterr().out.strip() == (
        "warning: --supervise needs the input state intact for retries; "
        "disabling --donate")
    assert train_cli.parse_args(["--arch", "nanogpt-124m",
                                 "--donate"]).donate
