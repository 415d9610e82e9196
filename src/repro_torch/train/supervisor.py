"""Supervised, crash-recoverable training loop (DESIGN.md §13).

Port of ``repro/train/supervisor.py``. The undonated step is pure —
state in, state out, its input left untouched — which makes host-level
recovery simple: any failed or wedged step attempt can be re-dispatched
from the last state the supervisor still holds, and a process crash can
be resumed from the last-good atomic checkpoint (``train/checkpoint.py``)
with no replayed side effects. The ``Supervisor`` wraps one step
invocation in exactly that contract:

  * **timeout/watchdog** — each attempt runs in a daemon watcher thread
    with a deadline. A wedged attempt (e.g. a ``stall`` fault, a hung
    collective) is *abandoned*: Python threads cannot be killed, so the
    supervisor orphans the thread (daemonic — it dies with the process)
    and dispatches the retry on a fresh one. This is only sound because
    the step is functional — the abandoned attempt's result, if it ever
    lands, is dropped on the floor. On a card the abandoned attempt goes
    on launching on the same stream as the retry: harmless, because it
    writes nothing the retry reads, but it holds its own memory until it
    ends. The watcher thread sets the caller's CUDA device (the current
    device is per thread).
  * **bounded retry with exponential backoff** — up to ``max_retries``
    re-dispatches per step, sleeping ``backoff_base_s * 2**attempt``
    (capped at ``backoff_max_s``) between attempts.
  * **reload on exception** — a raising attempt first retries from the
    in-memory state; if a checkpoint path is configured the final
    attempt(s) reload the last-good generation and continue from its
    step, trading up to ``checkpoint_every`` steps of progress for a
    live run.
  * **recovery telemetry** — every timeout / retry / reload / resume /
    periodic checkpoint emits a ``recovery`` record through the §10
    sink, and ``retries`` feeds the ``supervisor/retries`` metric.

Retries interact with host-side fault clauses deliberately: the stall
sleep (``FaultPlan.host_stall``) runs *inside* the watched call and only
on attempt 0, so a ``stall:...:ms=N`` with N above the step timeout
exercises the full timeout -> abandon -> clean-retry path.

The supervisor requires ``donate=False`` stepping: a donated step
updates its input state in place, also when it fails or is abandoned,
which would destroy the very state a retry needs (the train CLI
enforces this).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint


class SupervisorError(RuntimeError):
    """A step failed every retry (and reload, when configured)."""


class StepTimeout(TimeoutError):
    """A watched step attempt exceeded ``step_timeout_s``."""


@dataclass(frozen=True)
class SupervisorConfig:
    step_timeout_s: float | None = None   # None = no watchdog
    max_retries: int = 2                  # re-dispatches per step
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    checkpoint_path: str | None = None
    checkpoint_every: int = 0             # 0 = only on demand

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.step_timeout_s is not None and self.step_timeout_s <= 0:
            raise ValueError("step_timeout_s must be positive")


class Supervisor:
    """Drives ``run_step`` attempts per the config above.

    ``writer`` is an optional ``obs.sink.MetricsWriter``; recovery events
    are dropped silently when absent so the supervisor composes with
    metrics-off runs.
    """

    def __init__(self, cfg: SupervisorConfig, writer: Any = None,
                 state_like: Any = None):
        self.cfg = cfg
        self.writer = writer
        self.retries = 0          # total re-dispatches this run
        self.reloads = 0          # checkpoint reloads this run
        self._state_like = state_like
        self._last_reload_step = -1

    # ------------------------------------------------------------ events
    def _event(self, event: str, step: int, attempt: int, **extra) -> None:
        if self.writer is not None:
            self.writer.write("recovery", step=int(step), event=event,
                              attempt=int(attempt), **extra)

    # ----------------------------------------------------------- attempt
    def _attempt(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` under the watchdog. The watcher is a *daemon*
        thread (a ThreadPoolExecutor would be joined at interpreter
        exit, so one wedged attempt could hang process shutdown); on
        timeout the thread is simply orphaned — sound because the step
        is functional and its late result, if any, is discarded."""
        if self.cfg.step_timeout_s is None:
            return fn()
        box: dict[str, Any] = {}
        done = threading.Event()
        device = (torch.cuda.current_device()
                  if torch.cuda.is_available() else None)

        def runner():
            if device is not None:
                torch.cuda.set_device(device)
            try:
                box["result"] = fn()
            except BaseException as e:
                box["error"] = e
            finally:
                done.set()

        threading.Thread(target=runner, daemon=True,
                         name="supervised-step").start()
        if not done.wait(self.cfg.step_timeout_s):
            raise StepTimeout(
                f"attempt exceeded {self.cfg.step_timeout_s}s")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _backoff(self, attempt: int) -> None:
        time.sleep(min(self.cfg.backoff_base_s * (2 ** attempt),
                       self.cfg.backoff_max_s))

    # ---------------------------------------------------------- stepping
    def run_step(self, step_fn: Callable[..., Any], state: Any, *args,
                 step: int = -1, faults: Any = None) -> Any:
        """One supervised step: ``step_fn(state, *args)`` with timeout,
        retry, and (when configured) checkpoint-reload recovery.

        Returns ``(result, resumed_state, resumed_step)``. Normally
        ``result = step_fn(state, *args)`` and the other two are None.
        When every retry raised and a checkpoint is configured, the
        last-good generation is reloaded instead of raising: ``result``
        is None and the caller must install ``resumed_state`` and rewind
        its loop counter to ``resumed_step`` (the step to execute next)
        — re-stepping there picks the *correct* batch/schedule for that
        step, which is why the reload is not re-run in here. A second
        reload without forward progress past the first raises
        ``SupervisorError`` (a deterministic failure would otherwise
        reload forever). Host-side stall faults are applied inside the
        watched call, attempt 0 only. Raises ``SupervisorError`` when
        every recovery avenue is exhausted.
        """
        last_exc: BaseException | None = None
        for attempt in range(self.cfg.max_retries + 1):
            def call(attempt=attempt):
                if faults is not None:
                    faults.host_stall(step, attempt)
                return step_fn(state, *args)
            try:
                return self._attempt(call), None, None
            except StepTimeout as e:
                last_exc = e
                self._event("timeout", step, attempt)
            except Exception as e:
                last_exc = e
                self._event("retry", step, attempt, error=repr(e))
            if attempt < self.cfg.max_retries:
                self.retries += 1
                self._backoff(attempt)
        # retries exhausted: reload the last-good checkpoint if we can,
        # bounded to one reload per unit of forward progress
        if (self.cfg.checkpoint_path and self._state_like is not None
                and step > self._last_reload_step):
            try:
                ck_state, ck_step = load_checkpoint(
                    self.cfg.checkpoint_path, self._state_like)
            except Exception as e:
                last_exc = e
            else:
                self.reloads += 1
                self._last_reload_step = step
                resumed = ck_step if ck_step is not None else 0
                self._event("reload", step, self.cfg.max_retries,
                            resumed_step=resumed)
                return None, ck_state, resumed
        self._event("gave_up", step, self.cfg.max_retries)
        raise SupervisorError(
            f"step {step} failed after {self.cfg.max_retries + 1} "
            f"attempt(s)") from last_exc

    # ------------------------------------------------------- checkpoints
    def maybe_checkpoint(self, state: Any, step: int,
                         force: bool = False) -> bool:
        """Save the periodic last-good generation after completing
        ``step``; returns True when a checkpoint was written. The stored
        step is ``step + 1`` — the next step to execute — matching the
        train CLI's end-of-run convention, so a ``--resume`` (or a
        ``run_step`` reload) continues without re-running the step the
        checkpoint already contains."""
        every = self.cfg.checkpoint_every
        due = force or (every > 0 and step >= 0 and (step + 1) % every == 0)
        if not due or not self.cfg.checkpoint_path:
            return False
        save_checkpoint(self.cfg.checkpoint_path, state, step=step + 1)
        self._event("checkpoint", step, 0)
        return True

    def __enter__(self) -> "Supervisor":
        return self

    def __exit__(self, *exc) -> None:
        pass
