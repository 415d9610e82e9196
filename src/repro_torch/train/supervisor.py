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

**Over a group of ranks** (``group=g`` of P > 1 ``torch.distributed``
ranks, each its own process, with ``store=``, the job's store, and
``trainer=``, a ``Trainer`` over ``g``) the reference's one SPMD program
is P programs, and every rank moves through the same state machine in
step:

  * **one outcome per attempt, agreed by every rank.** A rank's main
    thread waits on three things: its attempt's end, a peer's failure
    and the deadline (``step_timeout_s``, which ranks require). It then
    posts its outcome under one key per (round, step, attempt, rank) of
    a ``PrefixStore`` over the job's store (the ``FileStore`` or
    ``TCPStore`` the group was made from), never through a collective of
    the groups the step uses, which a wedged attempt may block, and reads
    every rank's. The attempt counts only where it succeeded on every
    rank; else every rank drops its result, writes the same event
    (``retry`` where a rank raised, else ``timeout``) and retries, with
    the same attempt number, backoff and ``retries`` count. A rank that
    raises sets a failure key at once, so its peers abandon their
    attempts without waiting out the deadline, also from inside a
    collective: only the orphaned watcher thread stays there. A rank that
    posts nothing within ``2 * step_timeout_s`` of the attempt's start is
    taken for dead, and every other rank raises ``SupervisorError``
    naming it.
  * **a fresh generation of groups after every failed attempt.** An
    orphan may wake mid-retry and enter collectives, so the attempts run
    on generations of groups, never on ``g``: ``dist.new_group`` over
    the group's ranks with a bounded timeout (``2 * step_timeout_s``),
    after which an orphan's collectives end, and a new one after every
    failed attempt. ``dist.new_group`` is entered by every process of the
    job, so the supervised group must hold every rank of the world, as
    ``RankMesh`` requires of a mesh with two axes of several ranks; it is
    not ``dist.group.WORLD`` itself, whose collectives have no bound that
    would release an orphan (make it with ``dist.new_group``). A retired
    generation's groups (with its mesh's subgroups) are destroyed on each
    rank once its bound has passed since it was retired, at the next
    ``run_step`` or the next generation: a collective still inside one
    ends at its timeout, one begun after raises.
  * **each attempt's mutable state private to it.** Each generation has
    a ``Trainer`` of its own (``trainer.regroup``: the trainer's class,
    model, config, device and mesh over the generation's group, its
    mesh's subgroups bounded alike), so the byte checks, the records
    (``gathered``, ``broadcast_bytes``, ``aux_gathered``) and the mesh's
    ``batch_split`` and ``record`` an orphan writes are never a retry's.
    Each attempt runs that trainer's ``make_step()``, so ``run_step``
    takes no step (``step_fn=None``); ``Supervisor.current`` is the
    current generation's trainer. The state's tensors do not depend on
    the group and carry over unchanged.
  * **checkpoints.** The periodic save is ``trainer.save_checkpoint``
    (every rank at the same step, rank 0 writes the one-rank archive) and
    the reload ``trainer.load_checkpoint`` (each rank its rows or
    chunks), both on ``g``, which no attempt steps on, so their
    collectives wait the backend's default timeout whatever their length.
    Every rank then posts its outcome (and a load's step) to the store
    and reads every rank's, waiting as long, before the next attempt's
    clock starts; if one failed (or the loaded steps differ) every rank
    raises ``SupervisorError``.
  * **events** are written once per job where ``writer`` is a
    ``MetricsWriter(group=...)`` (rank 0 writes); their ``event``,
    ``step`` and ``attempt`` are the reference's. A ``stall`` clause
    ignores the worker, in the reference too, so it sleeps every rank.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable

import torch

from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint

# how often a rank's main thread looks at its attempt and at the store
POLL_S = 0.02


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
    metrics-off runs. ``group`` of more than one rank supervises them
    together (the module's docstring) and needs ``store`` and
    ``trainer``, the ``Trainer`` over ``group`` whose step every attempt
    runs and whose checkpoints are saved and loaded; every rank makes it
    at the same point (it makes the first generation of groups). One
    process saves and loads with ``train.checkpoint``'s functions.
    """

    def __init__(self, cfg: SupervisorConfig, writer: Any = None,
                 state_like: Any = None, group=None, store=None,
                 trainer=None):
        self.cfg = cfg
        self.writer = writer
        self.retries = 0          # total re-dispatches this run
        self.reloads = 0          # checkpoint reloads this run
        self._state_like = state_like
        self._last_reload_step = -1
        self.ranks = None         # the group's ranks; None: one process
        self.trainer = trainer
        self.current = None       # the current generation's trainer
        self.generation = -1      # of groups, on ranks
        self._retired: list = []  # (monotonic time its bound ends, group)
        if group is not None and group.size() > 1:
            self._join(group, store)

    def _join(self, group, store) -> None:
        import torch.distributed as dist
        n = group.size()
        if store is None:
            raise ValueError(
                f"a supervisor over {n} ranks agrees on each attempt through "
                "the job's store: give store=... (the FileStore or TCPStore "
                "the group was made from)")
        if group is dist.group.WORLD:
            raise ValueError(
                "a supervisor over ranks does not step on dist.group.WORLD, "
                "whose collectives have no bound that would release an "
                "abandoned attempt: give a group of the world's ranks made "
                "with dist.new_group")
        if self.cfg.step_timeout_s is None:
            raise ValueError(
                "a supervisor over ranks needs step_timeout_s: a rank that "
                "died is known only by its silence past the deadline")
        if n != dist.get_world_size():
            raise ValueError(
                f"a supervisor over {n} of {dist.get_world_size()} ranks: "
                "each generation of its groups is made with dist.new_group, "
                "which every process of the job enters, so the group must "
                "hold every rank of the world")
        if self.trainer is None or self.trainer.group is not group:
            raise ValueError(
                "a supervisor over ranks runs the step of a Trainer over "
                "the group on each generation of its groups: give "
                "trainer=... (a Trainer(..., group=group))")
        self.rank = dist.get_rank(group)
        self.ranks = dist.get_process_group_ranks(group)
        # the n-th supervisor a rank makes over the job: every rank makes
        # them in the same order, so the n-th one's keys are the same
        n = store.add(f"supervisor/made/r{self.rank}", 1)
        self._store = dist.PrefixStore(f"supervisor/{n}/", store)
        self._round = 0           # agreements so far, the same on every rank
        self._renew()

    # ------------------------------------------------------------ events
    def _event(self, event: str, step: int, attempt: int, **extra) -> None:
        if self.writer is not None:
            self.writer.write("recovery", step=int(step), event=event,
                              attempt=int(attempt), **extra)

    # ----------------------------------------------------------- attempt
    def _start(self, fn: Callable[[], Any]):
        """``fn`` on a daemon watcher thread (a ThreadPoolExecutor would be
        joined at interpreter exit, so one wedged attempt could hang
        process shutdown): (its result box, the event set when it ends)."""
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
        return box, done

    def _attempt(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` under the watchdog; on timeout the thread is simply
        orphaned — sound because the step is functional and its late
        result, if any, is discarded."""
        if self.cfg.step_timeout_s is None:
            return fn()
        box, done = self._start(fn)
        if not done.wait(self.cfg.step_timeout_s):
            raise StepTimeout(
                f"attempt exceeded {self.cfg.step_timeout_s}s")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _attempt_ranks(self, fn: Callable[[], Any], step: int,
                       attempt: int) -> Any:
        """``_attempt`` over the group: the result where the attempt
        succeeded on every rank; else, after a new generation of groups,
        a ``RuntimeError`` naming the ranks that raised and their errors,
        or ``StepTimeout`` where none raised."""
        key = f"{self._round}/s{step}/a{attempt}"
        t0 = time.monotonic()
        box, done = self._start(fn)
        deadline = t0 + self.cfg.step_timeout_s
        kind = None
        while kind is None:
            if done.wait(POLL_S):
                kind = "error" if "error" in box else "ok"
            elif self._store_op("check", [key + "/failed"]):
                kind = "abandoned"     # a peer failed: drop this attempt
            elif time.monotonic() > deadline:
                kind = "timeout"
        post = {"kind": kind}
        if kind == "error":
            post["error"] = repr(box["error"])
        if kind != "ok":
            self._store_op("set", key + "/failed", str(self.rank))
        posts = self._agree(key, post, t0 + 2 * self.cfg.step_timeout_s,
                            step, attempt)
        if all(p["kind"] == "ok" for p in posts):
            return box["result"]
        self._renew()
        errors = [f"rank {self.ranks[r]}: {p['error']}"
                  for r, p in enumerate(posts) if p["kind"] == "error"]
        if errors:
            raise RuntimeError("; ".join(errors)) from box.get("error")
        late = [self.ranks[r] for r, p in enumerate(posts)
                if p["kind"] == "timeout"]
        raise StepTimeout(f"attempt exceeded {self.cfg.step_timeout_s}s on "
                          f"ranks {late}")

    def _agree(self, key: str, post: dict, deadline: float, step: int,
               attempt: int) -> list[dict]:
        """Post this rank's ``post`` under ``key`` and read every rank's,
        in rank order; a rank that posts nothing by ``deadline`` (a
        monotonic time) is taken for dead: ``SupervisorError``."""
        self._store_op("set", f"{key}/r{self.rank}", json.dumps(post))
        self._round += 1
        keys = [f"{key}/r{r}" for r in range(len(self.ranks))]
        while not self._store_op("check", keys):
            if time.monotonic() > deadline:
                dead = [self.ranks[r] for r, k in enumerate(keys)
                        if not self._store_op("check", [k])]
                if dead:
                    self._event("gave_up", step, attempt, dead=dead)
                    raise SupervisorError(
                        f"step {step}, attempt {attempt}: rank(s) {dead} of "
                        "the group posted nothing in time and are taken for "
                        "dead")
            time.sleep(POLL_S)
        return [json.loads(self._store_op("get", k)) for k in keys]

    def _store_op(self, op: str, *args):
        """``op`` of the job's store; its failure (the process that hosts
        a ``TCPStore`` gone) ends the run: ``SupervisorError``."""
        try:
            return getattr(self._store, op)(*args)
        except Exception as e:
            raise SupervisorError(f"the job's store failed ({op}): {e!r}") \
                from e

    def _timeout_s(self) -> float:
        # how long a generation's collectives wait: twice the deadline,
        # after which an orphan's end
        return 2 * self.cfg.step_timeout_s

    def _renew(self) -> None:
        """A new generation of groups over the group's ranks, with a
        bounded timeout, and its trainer; every rank makes it at the same
        point (when the supervisor is made, or after an agreement). The
        one it replaces is retired."""
        import torch.distributed as dist
        now = time.monotonic()
        if self.current is not None:
            self._retired.append((now + self._timeout_s(),
                                  self.current.group))
        self._sweep(now)
        self.generation += 1
        timeout = timedelta(seconds=self._timeout_s())
        g = dist.new_group(self.ranks, timeout=timeout)
        self.current = self.trainer.regroup(g, timeout)
        self._step = self.current.make_step()

    def _sweep(self, now: float) -> None:
        """Destroy the retired generations whose bound has passed."""
        from repro_torch.dist.sharding import destroy_group
        for end, g in [r for r in self._retired if r[0] <= now]:
            destroy_group(g)
        self._retired = [r for r in self._retired if r[0] > now]

    def _backoff(self, attempt: int) -> None:
        time.sleep(min(self.cfg.backoff_base_s * (2 ** attempt),
                       self.cfg.backoff_max_s))

    # ---------------------------------------------------------- stepping
    def run_step(self, step_fn: Callable[..., Any] | None, state: Any, *args,
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
        every recovery avenue is exhausted. On ranks ``step_fn`` is None:
        each attempt runs the current generation's trainer's step.
        """
        if self.ranks is not None:
            if step_fn is not None:
                raise ValueError(
                    "on ranks each attempt runs the step of its "
                    "generation's trainer (trainer=...): give step_fn=None")
            self._sweep(time.monotonic())
        last_exc: BaseException | None = None
        for attempt in range(self.cfg.max_retries + 1):
            fn = step_fn if self.ranks is None else self._step

            def call(attempt=attempt, fn=fn):
                if faults is not None:
                    faults.host_stall(step, attempt)
                return fn(state, *args)
            try:
                if self.ranks is None:
                    return self._attempt(call), None, None
                return self._attempt_ranks(call, step, attempt), None, None
            except StepTimeout as e:
                last_exc = e
                self._event("timeout", step, attempt)
            except SupervisorError:
                raise               # a rank of the group is dead
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
            loaded = None
            try:
                loaded = (load_checkpoint if self.ranks is None
                          else self.trainer.load_checkpoint)(
                    self.cfg.checkpoint_path, self._state_like)
            except Exception as e:
                last_exc = e
            if self.ranks is not None:
                loaded = self._agree_load(loaded, last_exc, step)
            if loaded is not None:
                ck_state, ck_step = loaded
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

    def _agree_load(self, loaded, error, step: int):
        """Every rank's reload outcome: ``loaded`` where every rank loaded
        the same step, else every rank gives up."""
        post = ({"ok": True, "step": loaded[1]} if loaded is not None
                else {"ok": False, "error": repr(error)})
        posts = self._agree_checkpoint("load", post, step,
                                       self.cfg.max_retries)
        failed = [f"rank {self.ranks[r]}: {p['error']}"
                  for r, p in enumerate(posts) if not p["ok"]]
        steps = {p["step"] for p in posts if p["ok"]}
        if failed or len(steps) > 1:
            self._event("gave_up", step, self.cfg.max_retries,
                        error="; ".join(failed) or f"steps {sorted(steps)}")
            raise SupervisorError(
                f"step {step}: the reload failed on "
                + ("; ".join(failed) if failed else
                   f"no rank, but the ranks loaded steps {sorted(steps)}")
            ) from error
        return loaded

    def _agree_checkpoint(self, what: str, post: dict, step: int,
                          attempt: int) -> list[dict]:
        """``_agree`` after a save or a load on ``trainer``'s group, whose
        collectives wait the backend's default timeout: as long."""
        import torch.distributed as dist
        return self._agree(f"{self._round}/{what}/s{step}", post,
                           time.monotonic()
                           + dist.default_pg_timeout.total_seconds(),
                           step, attempt)

    # ------------------------------------------------------- checkpoints
    def maybe_checkpoint(self, state: Any, step: int,
                         force: bool = False) -> bool:
        """Save the periodic last-good generation after completing
        ``step``; returns True when a checkpoint was written. The stored
        step is ``step + 1`` — the next step to execute — matching the
        train CLI's end-of-run convention, so a ``--resume`` (or a
        ``run_step`` reload) continues without re-running the step the
        checkpoint already contains. On ranks every rank calls it at the
        same step (the save is collective)."""
        every = self.cfg.checkpoint_every
        due = force or (every > 0 and step >= 0 and (step + 1) % every == 0)
        if not due or not self.cfg.checkpoint_path:
            return False
        if self.ranks is None:
            save_checkpoint(self.cfg.checkpoint_path, state, step=step + 1)
        else:
            error = None
            try:
                self.trainer.save_checkpoint(self.cfg.checkpoint_path,
                                             state, step=step + 1)
            except Exception as e:
                error = e
            posts = self._agree_checkpoint(
                "save", {"ok": error is None, "error": repr(error)}, step, 0)
            failed = [f"rank {self.ranks[r]}: {p['error']}"
                      for r, p in enumerate(posts) if not p["ok"]]
            if failed:
                raise SupervisorError(
                    f"step {step}: the checkpoint failed on "
                    + "; ".join(failed)) from error
        self._event("checkpoint", step, 0)
        return True

    def __enter__(self) -> "Supervisor":
        return self

    def __exit__(self, *exc) -> None:
        pass
