"""The supervisor over ``torch.distributed`` ranks (DESIGN.md §13).

On the CPU over gloo, for each of two paths, the group path
(``Trainer(..., group=g)``) and the mesh ``MeshShape(data=1, model=2)``
(the weights cut on ``model``), two processes (``torch.multiprocessing``
with a ``FileStore`` under ``tmp_path``) train reduced nanogpt-124m, 2
workers, packed ``top10+natural`` / ``natural``, 4 steps through
``launch.train.run_steps`` under ``Supervisor(..., group=g,
store=store, trainer=tr)``. A ``Trainer`` of the test's own, whose step
runs a wrapper first (and a wrapper around one all-gather), fails one
rank on a schedule of (step, attempt):

  (a) rank 1 raises at step 1, attempt 0: every rank retries once, sooner
      than the deadline;
  (b) rank 1 sleeps past the deadline inside its first gather of step 2:
      every rank retries on a new generation of groups, while the orphan
      wakes and finishes its step on the old one;
  (c) a checkpoint every 2 steps, rank 0 raising on every attempt of step
      3: every rank reloads the same generation (the mesh's through the
      model-cut ``Trainer.load_checkpoint``), rewinds to step 2 and
      finishes; on the group path, raising on every later visit too,
      the second reload without progress raises on both ranks;
  (d) rank 1 exits at step 1: rank 0 raises ``SupervisorError`` naming it
      within ``2 * step_timeout_s + 5`` s.

On the group path rank 1 also raises at attempt 0 of steps 1-3, the
supervisor's clock moved past each retired generation's bound between
steps: after the third retry generations 0 and 1 are destroyed, 2 and 3
live. On the mesh path a checkpoint after step 0 whose write sleeps past
twice the deadline finishes, as its collectives run on ``g``, which no
attempt steps on, and step 1 follows: its losses are the unsupervised
run's (its events are not held to the reference's, since its short
deadline may time a slow step out).

On the group path a ``stall`` clause sleeps every rank past the deadline:
one timeout, one retry. Each run's losses, x and W (gathered whole) are
bit-equal to the same ranks' unsupervised run, and the group path's to
one process's; each rank's recovery events (``event``, ``step``,
``attempt``, ``resumed_step``) and its ``retries`` and ``reloads`` equal
those of the reference's ``repro.train.supervisor.Supervisor``, driven
here with a plain-Python step that fails, stalls and reloads on the same
schedule; rank 0 alone writes them to a ``MetricsWriter(group=g)``.

A dead rank ends its job, so each path has a spawn of its own, both
started at once. Every process runs one torch thread, and every join has
a timeout, after which the processes are killed and the test fails.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_threads import one_torch_thread  # noqa: F401

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.schedule import warmup_linear_decay
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.train import run_steps
from repro_torch.models.api import build_model
from repro_torch.train.faults import parse_faults
from repro_torch.train.trainer import Trainer, TrainerConfig

STEPS, SEQ, BATCH = 4, 16, 4
BASE = dict(n_workers=2, beta=0.5, w2s="top10+natural", s2w="natural")
# the deadline: a mesh step's retry beside the orphans' step, under the
# suite's parallel load, takes several seconds
TIMEOUT_S = 8.0
WEDGE_S = TIMEOUT_S + 0.3         # past the deadline
# the deadlines of (d) and of the slow save: a step that passes one is
# retried on a new generation, whose trainer's first step is as slow, and
# three timeouts at step 0 give up; under the suite's load a first step
# takes over 3 s
DEAD_TIMEOUT_S = 5.0
SAVE_TIMEOUT_S = 5.0
# the slow save's sleep, past a generation's bound, after step 0 of 2
SLOW_SAVE_S = 2 * SAVE_TIMEOUT_S + 0.5
SAVE_STEPS = 2
REF_TIMEOUT_S, REF_WEDGE_S = 2.0, 2.5   # the reference's, in one process
JOIN_S = 150
PATHS = ("group", "mesh")
# case -> rank -> {(step, attempt, visit): action}; None matches any
# attempt or visit (a visit: one run_step of the step, the first is 0)
CASES = {
    "raise": {1: {(1, 0, 0): "raise"}},
    "wedge": {1: {(2, 0, 0): "wedge"}},
    "reload": {0: {(3, None, 0): "raise"}},
    "reload_twice": {0: {(3, None, None): "raise"}},
    "retire": {1: {(s, 0, 0): "raise" for s in (1, 2, 3)}},
    "stall": {},
}
RELOADS = ("reload", "reload_twice")
# the cases only the group path runs
GROUP_ONLY = ("reload_twice", "retire", "stall")
STALL = "stall:w=0:steps=1:ms={ms}"


def _stall(ms: float) -> str:
    return STALL.format(ms=int(ms * 1000))


class _Schedule:
    """The actions of one rank's schedule, by the (step, attempt, visit)
    of each call; a call is known by its batch (one object a visit)."""

    def __init__(self, actions: dict):
        self.actions = actions
        self.visits: dict[int, list] = {}
        self.calls: list = []       # [batch, calls so far]

    def take(self, step: int, batch) -> str | None:
        seen = self.visits.setdefault(step, [])
        if not any(b is batch for b in seen):
            seen.append(batch)
            self.calls.append([batch, 0])
        visit = next(i for i, b in enumerate(seen) if b is batch)
        entry = next(c for c in self.calls if c[0] is batch)
        attempt = entry[1]
        entry[1] += 1
        for (s, a, v), action in self.actions.items():
            if s == step and a in (None, attempt) and v in (None, visit):
                return action
        return None


class _Batch(dict):
    """A batch that knows its step."""


class _Tagged:
    def __init__(self, data):
        self.data, self.clock = data, None

    def batch_at(self, i: int) -> _Batch:
        if self.clock is not None:
            self.clock.offset += self.clock.skip
        b = _Batch(self.data.batch_at(i))
        b.step = i
        return b


class _Recorder:
    """A writer that keeps each recovery event and hands every record on
    to ``sink`` (a ``MetricsWriter``) where given."""

    def __init__(self, sink=None):
        self.events, self.sink = [], sink

    def write(self, kind: str, **fields) -> None:
        if kind == "recovery":
            self.events.append([fields["event"], fields["step"],
                                fields["attempt"],
                                fields.get("resumed_step")])
        if self.sink is not None:
            self.sink.write(kind, **fields)


def _digest(tree) -> str:
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
                     .numpy().tobytes())
    walk(tree)
    return h.hexdigest()


class _Faulty(Trainer):
    """A trainer whose step runs the armed injector's action first; the
    supervisor's generations are of its class (``Trainer.regroup``), and
    each is kept in ``made``."""
    inj = None
    made: list = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        _Faulty.made.append(self)

    def make_step(self):
        step = super().make_step()

        def wrapped(state, batch, t):
            _Faulty.inj.before(batch)
            return step(state, batch, t)
        return wrapped


class _Clock:
    """The supervisor's ``time``, its monotonic clock moved on by
    ``skip`` at each batch drawn (between steps)."""

    def __init__(self, skip: float):
        self.skip, self.offset = skip, 0.0

    def __getattr__(self, name):
        return getattr(time, name)

    def monotonic(self) -> float:
        return time.monotonic() + self.offset


def _setup(group, path: str, faults: str | None = None, cls=Trainer):
    from repro_torch.dist.sharding import MeshShape
    kw = dict(BASE)
    if faults:
        kw["faults"] = parse_faults(faults, BASE["n_workers"])
    cfg = get_config("nanogpt-124m").reduced()
    tr = cls(build_model(cfg), TrainerConfig(**kw), device="cpu",
             group=group,
             mesh=MeshShape(data=1, model=2) if path == "mesh" else None)
    data = SyntheticLM(cfg, ShapeSpec("t", "train", SEQ, BATCH),
                       n_workers=BASE["n_workers"], seed=0, device="cpu",
                       group=tr.worker_group if group is not None else None)
    return tr, _Tagged(data), warmup_linear_decay(0.01, 3, STEPS)


class _Injector:
    """The test's wrapper around every ``_Faulty`` trainer's step, around
    the all-gather and around a checkpoint's write: the step's action
    from the armed schedule, a wedge (one sleep in the first gather of
    the thread that armed it) and a slow first write."""

    def __init__(self, rank: int, tmp: str, path: str):
        self.rank, self.tmp, self.path = rank, tmp, path
        self.schedule = _Schedule({})
        self.wedge = None
        self.slow_save = False
        self.log: dict = {}

    def install(self) -> None:
        from repro_torch.dist import sharding
        from repro_torch.train import checkpoint
        gather, write = sharding.gather_tensor, checkpoint._write_archive
        inj = self
        _Faulty.inj = self

        def wrapped_write(*a, **k):
            if inj.slow_save:
                inj.slow_save = False
                t = time.time()
                time.sleep(SLOW_SAVE_S)
                inj.log["save_s"] = time.time() - t
            return write(*a, **k)

        def wrapped_gather(*a, **k):
            if inj.wedge == threading.get_ident():
                inj.wedge = None
                inj.log["wedged_at"] = time.time()
                time.sleep(WEDGE_S)
                inj.log["woke_at"] = time.time()
            return gather(*a, **k)

        sharding.gather_tensor = wrapped_gather
        checkpoint._write_archive = wrapped_write

    def arm(self, actions: dict, slow_save: bool = False) -> None:
        self.schedule, self.log = _Schedule(actions), {}
        self.slow_save = slow_save

    def before(self, batch) -> None:
        action = self.schedule.take(batch.step, batch)
        if action == "raise":
            raise RuntimeError(f"injected on rank {self.rank} at step "
                               f"{batch.step}")
        if action == "wedge":
            self.wedge = threading.get_ident()
        if action == "exit":
            with open(os.path.join(self.tmp, f"exit_{self.path}.json"),
                      "w") as f:
                json.dump({"t": time.time()}, f)
            os._exit(0)


def _record(tr, run: dict) -> dict:
    whole = tr.gather_server(run["state"])
    return {"losses": run["losses"], "x": _digest(whole["x"]),
            "w": _digest(whole["w"])}


def _case(inj, group, store, tmp: str, path: str, rank: int,
          case: str) -> dict:
    """One supervised run of ``case`` (the schedule's for this rank)."""
    import torch.distributed as dist
    from repro_torch.dist import sharding
    from repro_torch.obs.sink import MetricsWriter
    from repro_torch.train import supervisor
    from repro_torch.train.checkpoint import state_template
    from repro_torch.train.supervisor import (Supervisor, SupervisorConfig,
                                              SupervisorError)
    tr, data, sched = _setup(group, path, _stall(WEDGE_S)
                             if case == "stall" else None, _Faulty)
    state = tr.init(0)
    reload = case in RELOADS + ("slow_save",)
    sink = MetricsWriter(os.path.join(tmp, f"events_{path}_{case}.jsonl"),
                         group=group)
    rec = _Recorder(sink)
    sup = Supervisor(SupervisorConfig(
        step_timeout_s=SAVE_TIMEOUT_S if case == "slow_save" else TIMEOUT_S,
        checkpoint_path=(os.path.join(tmp, f"ck_{path}_{case}")
                         if reload else None),
        checkpoint_every=(1 if case == "slow_save" else 2) if reload else 0),
        writer=rec, state_like=state_template(state), group=group,
        store=store, trainer=tr)
    inj.arm(CASES.get(case, {}).get(rank, {}),
            slow_save=case == "slow_save" and rank == 0)
    if case == "retire":
        data.clock = supervisor.time = _Clock(2 * TIMEOUT_S + 1)
    out = {"error": None}
    t0 = time.time()
    try:
        run = run_steps(tr, state, data, sched, SAVE_STEPS
                        if case == "slow_save" else STEPS, sup=sup)
        out.update(_record(tr, run))
        out["step_s"] = run["step_s"]
        b = tr.wire_budget()
        out["budget"] = {"w2s": [tr.n_local * s for s in b.w2s_sizes],
                         "s2w": sorted(b.s2w_sizes)}
        out["gathered"] = sup.current.gathered
        out["broadcast"] = sup.current.broadcast_bytes
        out["group_timeout_s"] = sup.current.group._get_backend(
            torch.device("cpu")).options._timeout.total_seconds()
    except SupervisorError as e:
        out["error"] = str(e)
    finally:
        supervisor.time = time
    t_end = time.time()
    # each generation's group, and whether it (and every entry of the
    # mesh's subgroups made from it) is still there
    gens = [t.group for t in _Faulty.made[1:]]
    _Faulty.made.clear()
    out["alive"] = [g in dist.distributed_c10d._world.pg_map
                    or any(k[0] is g for k in sharding._SUBGROUPS)
                    for g in gens]
    while "wedged_at" in inj.log and "woke_at" not in inj.log \
            and time.time() < t_end + WEDGE_S:
        time.sleep(0.05)          # the orphan wakes, maybe after the run
    out.update(wall_s=t_end - t0, t_end=t_end, events=rec.events,
               retries=sup.retries, reloads=sup.reloads,
               generation=sup.generation, log=dict(inj.log))
    sink.close()
    return out


def _rank_main(rank: int, tmp: str, path: str) -> None:
    """One of a path's two ranks: the unsupervised run, the cases, the
    refusals (group path), then the dead rank."""
    import torch.distributed as dist
    from repro_torch.train.supervisor import (Supervisor, SupervisorConfig,
                                              SupervisorError)
    torch.set_num_threads(1)
    results: dict = {}
    out_path = os.path.join(tmp, f"{path}_rank{rank}.json")

    def dump():
        with open(out_path, "w") as f:
            json.dump(results, f)

    try:
        store = dist.FileStore(os.path.join(tmp, f"store_{path}"), 2)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=2)
        group = dist.new_group([0, 1])
        inj = _Injector(rank, tmp, path)
        inj.install()
        for name, faults in (("plain", None), ("plain_stall",
                                               _stall(WEDGE_S))):
            if name == "plain_stall" and path != "group":
                continue
            tr, data, sched = _setup(group, path, faults)
            results[name] = _record(tr, run_steps(tr, tr.init(0), data,
                                                  sched, STEPS))
        for case in CASES:
            if case in GROUP_ONLY and path != "group":
                continue
            results[case] = _case(inj, group, store, tmp, path, rank, case)
        if path == "mesh":
            results["slow_save"] = _case(inj, group, store, tmp, path, rank,
                                         "slow_save")
        if path == "group":
            refusals = {}
            for name, kw in (
                    ("world", dict(group=dist.group.WORLD, store=store)),
                    ("no_store", dict(group=group)),
                    ("no_timeout", dict(group=group, store=store)),
                    ("no_trainer", dict(group=group, store=store))):
                cfg = SupervisorConfig(step_timeout_s=None if name ==
                                       "no_timeout" else TIMEOUT_S)
                try:
                    Supervisor(cfg, **kw)
                    refusals[name] = None
                except ValueError as e:
                    refusals[name] = str(e)
            results["refusals"] = refusals
        dump()
        # (d): rank 1 exits at step 1, rank 0 names it
        tr, data, sched = _setup(group, path, cls=_Faulty)
        sup = Supervisor(SupervisorConfig(step_timeout_s=DEAD_TIMEOUT_S),
                         group=group, store=store, trainer=tr)
        inj.arm({(1, 0, 0): "exit"} if rank == 1 else {})
        try:
            run_steps(tr, tr.init(0), data, sched, STEPS, sup=sup)
            results["dead"] = {"error": None}
        except SupervisorError as e:
            results["dead"] = {"error": str(e), "t": time.time()}
    except Exception:
        results["crash"] = traceback.format_exc()
    dump()
    # peers may be dead and orphans blocked in collectives: no teardown
    os._exit(0)


def _reference(tmp: str) -> dict:
    """The reference's supervisor, one process, a plain-Python step on
    each case's schedule (every rank's actions at once)."""
    from repro.train.faults import parse_faults as jparse_faults
    from repro.train.supervisor import Supervisor as JSupervisor
    from repro.train.supervisor import SupervisorConfig as JConfig
    from repro.train.supervisor import SupervisorError as JError
    out = {}
    for case, per_rank in CASES.items():
        sched = _Schedule({k: v for actions in per_rank.values()
                           for k, v in actions.items()})

        def step_fn(state, batch):
            action = sched.take(batch.step, batch)
            if action == "raise":
                raise RuntimeError(f"injected at step {batch.step}")
            if action == "wedge":
                time.sleep(REF_WEDGE_S)
            return {"x": state["x"] + 1}

        reload = case in RELOADS
        rec = _Recorder()
        like = {"x": np.zeros(2, np.float32)}
        sup = JSupervisor(JConfig(
            step_timeout_s=REF_TIMEOUT_S,
            checkpoint_path=(os.path.join(tmp, f"ref_ck_{case}")
                             if reload else None),
            checkpoint_every=2 if reload else 0), writer=rec, state_like=like)
        faults = (jparse_faults(_stall(REF_WEDGE_S), 2) if case == "stall"
                  else None)
        state, i, raised = dict(like), 0, False
        try:
            while i < STEPS:      # launch.train's loop
                batch = _Batch()
                batch.step = i
                result, rs_state, rs_step = sup.run_step(
                    step_fn, state, batch, step=i, faults=faults)
                if result is None:
                    state, i = rs_state, rs_step
                    continue
                state = result
                sup.maybe_checkpoint(state, i)
                i += 1
        except JError:
            raised = True
        out[case] = {"events": rec.events, "retries": sup.retries,
                     "reloads": sup.reloads, "raised": raised}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both paths' ranks, run the reference and one process here
    meanwhile, and collect everything."""
    tmp = str(tmp_path_factory.mktemp("supervisor_ranks"))
    spawns = {path: mp.start_processes(_rank_main, args=(tmp, path),
                                       nprocs=2, join=False,
                                       start_method="spawn")
              for path in PATHS}
    try:
        ref = _reference(tmp)
        tr, data, sched = _setup(None, "group")
        one = _record(tr, run_steps(tr, tr.init(0), data, sched, STEPS))
        deadline = time.time() + JOIN_S
        for ctx in spawns.values():
            done = False
            while not done and time.time() < deadline:
                done = ctx.join(timeout=2)
    finally:
        hung = []
        for ctx in spawns.values():
            for p in ctx.processes:
                if p.is_alive():
                    hung.append(p.pid)
                    p.kill()
    assert not hung, f"processes {hung} did not end in {JOIN_S} s"
    got = {}
    for path in PATHS:
        for r in range(2):
            with open(os.path.join(tmp, f"{path}_rank{r}.json")) as f:
                got[path, r] = json.load(f)
            assert "crash" not in got[path, r], got[path, r]["crash"]
        with open(os.path.join(tmp, f"exit_{path}.json")) as f:
            got[path, "exit_t"] = json.load(f)["t"]
    return {"tmp": tmp, "ref": ref, "one": one, "ranks": got}


def _cases(path: str) -> list[str]:
    return [c for c in CASES if c not in GROUP_ONLY or path == "group"]


PARAMS = [(p, c) for p in PATHS for c in _cases(p)]


@pytest.mark.parametrize("path,case", PARAMS)
def test_supervised_ranks_are_the_unsupervised_run(runs, path, case):
    """Losses, x and W gathered whole bit-equal to the same ranks'
    unsupervised run (with the stall clause for ``stall``), and the group
    path's to one process's; the run whose every later visit raises gives
    up on both ranks instead."""
    for r in range(2):
        got = runs["ranks"][path, r][case]
        if case == "reload_twice":
            assert got["error"] and "failed after 3 attempt(s)" \
                in got["error"], got["error"]
            continue
        assert got["error"] is None, got["error"]
        want = dict(runs["ranks"][path, r]["plain_stall" if case == "stall"
                                           else "plain"])
        if case == "reload":
            # steps 0-3, then step 2 again from the archive and step 3
            assert got["losses"][3] == want["losses"][2]
            del got["losses"][3]
        for key in ("losses", "x", "w"):
            assert got[key] == want[key], (r, key)
        if path == "group" and case != "stall":
            for key in ("losses", "x", "w"):
                assert got[key] == runs["one"][key], (r, key)


@pytest.mark.parametrize("path,case", PARAMS)
def test_events_and_counts_are_the_references(runs, path, case):
    """Each rank's recovery events (event, step, attempt, resumed_step),
    retries and reloads equal the reference supervisor's on the same
    schedule; rank 0 alone wrote them, once, to the group's sink."""
    want = runs["ref"][case]
    for r in range(2):
        got = runs["ranks"][path, r][case]
        assert got["events"] == want["events"], (r, got["events"])
        assert (got["retries"], got["reloads"]) == (want["retries"],
                                                    want["reloads"])
        assert (got["error"] is not None) == want["raised"]
    with open(os.path.join(runs["tmp"], f"events_{path}_{case}.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [[r["event"], r["step"], r["attempt"], r.get("resumed_step")]
            for r in rows if r["kind"] == "recovery"] == want["events"]


@pytest.mark.parametrize("path", PATHS)
def test_a_raise_on_one_rank_retries_every_rank_at_once(runs, path):
    """Rank 1 raises at step 1: both ranks abandon the attempt, the peer
    from inside its collective, and retry on a new generation without
    waiting for the deadline."""
    for r in range(2):
        got = runs["ranks"][path, r]["raise"]
        assert got["events"][0][:3] == ["retry", 1, 0]
        assert got["generation"] == 1
        assert got["step_s"][1] < TIMEOUT_S, got["step_s"]


@pytest.mark.parametrize("path", PATHS)
def test_a_wedged_rank_retries_on_a_new_generation(runs, path):
    """Rank 1 sleeps past the deadline in its first gather of step 2:
    both ranks time out and retry on generation 1 (its collectives
    bounded by twice the deadline), whose trainer moves the budget's
    gathers and broadcasts for steps 2 and 3 alone, however the orphans
    of generation 0 end; rank 1's orphan wakes."""
    for r in range(2):
        got = runs["ranks"][path, r]["wedge"]
        assert got["events"] == [["timeout", 2, 0, None]]
        assert got["generation"] == 1
        # the generation's collectives end after twice the deadline
        assert got["group_timeout_s"] == 2 * TIMEOUT_S
        assert got["gathered"] == got["budget"]["w2s"] * 2
        assert sorted(got["broadcast"]) == sorted(got["budget"]["s2w"] * 2)
        assert TIMEOUT_S <= got["step_s"][2] < 2 * TIMEOUT_S, got["step_s"]
    log = runs["ranks"][path, 1]["wedge"]["log"]
    assert log["woke_at"] - log["wedged_at"] >= WEDGE_S


@pytest.mark.parametrize("path", PATHS)
def test_every_rank_reloads_the_same_generation(runs, path):
    """Rank 0 raises on every attempt of step 3: each rank's retries run
    on generations 1-3, then both reload the archive saved after step 1,
    rewind to step 2 and finish; on the group path the second reload
    without progress gives up on both."""
    for r in range(2):
        got = runs["ranks"][path, r]["reload"]
        assert got["generation"] == 3
        assert ["reload", 3, 2, 2] in got["events"]
        if path == "group":
            twice = runs["ranks"][path, r]["reload_twice"]
            assert twice["events"][-1][:3] == ["gave_up", 3, 2]


@pytest.mark.parametrize("path", PATHS)
def test_a_dead_rank_is_named(runs, path):
    """Rank 1 exits at step 1: rank 0 raises SupervisorError naming it
    within 2 x step_timeout_s + 5 s of the exit."""
    got = runs["ranks"][path, 0]["dead"]
    assert got["error"] and "[1]" in got["error"], got["error"]
    took = got["t"] - runs["ranks"][path, "exit_t"]
    assert 0 < took < 2 * DEAD_TIMEOUT_S + 5, took


def test_a_group_needs_a_store_a_timeout_a_trainer_and_not_the_world(
        runs):
    refusals = runs["ranks"]["group", 0]["refusals"]
    assert "store" in refusals["no_store"]
    assert "step_timeout_s" in refusals["no_timeout"]
    assert "dist.group.WORLD" in refusals["world"]
    assert "trainer=" in refusals["no_trainer"]


def test_retired_generations_are_destroyed_after_their_bound(runs):
    """Rank 1 raises at attempt 0 of steps 1-3, the clock moved past a
    generation's bound between steps: after the third retry generations
    0 and 1 are destroyed on both ranks; 2, retired within its bound, and
    3, the current one, are not."""
    for r in range(2):
        got = runs["ranks"]["group", r]["retire"]
        assert got["generation"] == 3
        assert got["alive"] == [False, False, True, True]


def test_a_save_longer_than_a_generations_bound_finishes(runs):
    """Rank 0's write of the checkpoint after step 0 sleeps past twice
    the deadline: the save runs on the supervised group, not on a
    generation's, so neither rank fails, step 1 follows, both save after
    it too, and the losses are the unsupervised run's."""
    got = runs["ranks"]["mesh", 0]["slow_save"]
    assert got["log"]["save_s"] >= 2 * SAVE_TIMEOUT_S
    for r in range(2):
        got = runs["ranks"]["mesh", r]["slow_save"]
        assert got["error"] is None, got["error"]
        assert [e[:2] for e in got["events"] if e[0] == "checkpoint"] \
            == [["checkpoint", 0], ["checkpoint", 1]]
        assert got["losses"] \
            == runs["ranks"]["mesh", r]["plain"]["losses"][:SAVE_STEPS]
