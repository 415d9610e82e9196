"""Deterministic fault injection for chaos runs (DESIGN.md §11).

Port of ``repro/train/faults.py``. A ``FaultPlan`` is a seeded, declared
schedule of production failure modes, injected inside the step:

  ``drop``       worker j is absent for steps [start, stop) — ANDed into
                 the participation mask (``drop_mask``), so its EF21
                 error/momentum state freezes like a scheduled absence;
  ``nan``/``inf`` worker j's gradient for one (seeded-chosen) parameter
                 leaf is poisoned with NaN/Inf for steps [start, stop) —
                 the poison flows through momentum into the payload,
                 where the optimizer's non-finite guard demotes the
                 worker for the step;
  ``flip``       XOR a seeded set of byte positions of the gathered w2s
                 u8 wire buffer for steps [start, stop) — a torn wire
                 payload. Flips that make a float payload NaN/Inf are
                 caught by the guard; flips of indices and codes decode
                 to finite (or, for a Natural code, possibly infinite)
                 garbage that reaches the fold, as in the reference.

The fault sites (leaf choice, byte positions, XOR masks) come from
``numpy.random.default_rng`` with the reference's seeds and draw order,
so the port poisons the same leaf and flips the same bytes with the same
masks. Whether a fault is active is decided from the host's step number;
each injection is a ``torch.where`` on a flag already on the device (a
cached tensor), so a step with faults waits on nothing a step without
them does not.

Two host-side clauses drive the supervisor instead of the step:

  ``stall``      worker j's step is delayed by N milliseconds for steps
                 [start, stop) (``host_stall`` sleeps before dispatch);
                 retries skip the sleep, so a stalled step recovers on
                 attempt 1.
  ``crash``      hard ``os._exit(CRASH_EXIT)`` at one step (``host_crash``)
                 — simulated power loss; fires only on a run that started
                 from step 0, so the ``--resume`` run sails past it.

CLI grammar (``parse_faults``), comma-separated clauses:

    drop:w=1:steps=5-10          worker 1 absent for steps 5..9
    nan:w=0:steps=7              NaN gradient leaf on worker 0 at step 7
    inf:w=2:steps=3-6            Inf gradient leaf, worker 2, steps 3..5
    flip:steps=4:bits=8          8 flipped wire bytes at step 4
    stall:w=1:steps=5-7:ms=500   worker 1 stalls 500 ms at steps 5..6
    crash:step=9                 process hard-exits at step 9 (fresh
                                 runs only)

``steps=a-b`` is the half-open range [a, b); ``steps=a`` means [a, a+1).
"""
from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass, field

import numpy as np
import torch

_CLAUSE_RE = re.compile(
    r"^(drop|nan|inf|flip|stall|crash)((?::[a-z_]+=[0-9-]+)*)$")

#: exit status of a ``crash:step=s`` fault — distinct from generic
#: failures so the soak harness can assert the crash actually fired.
CRASH_EXIT = 43


@dataclass(frozen=True)
class GradFault:
    worker: int
    start: int
    stop: int
    mode: str           # "nan" | "inf"
    leaf_id: int = -1   # resolved lazily from the seed when < 0


@dataclass(frozen=True)
class DropFault:
    worker: int
    start: int
    stop: int


@dataclass(frozen=True)
class WireFault:
    start: int
    stop: int
    n_bits: int = 8     # byte positions XORed per injection


@dataclass(frozen=True)
class StallFault:
    worker: int
    start: int
    stop: int
    ms: int = 1000      # host-side delay per stalled step


@dataclass(frozen=True)
class CrashFault:
    step: int
    # half-open range view, so the shared validation/active_any logic
    # treats a crash like any other single-step fault
    @property
    def start(self):
        return self.step

    @property
    def stop(self):
        return self.step + 1


@dataclass(frozen=True)
class FaultPlan:
    """Seeded, declared fault schedule — see module docstring."""
    n_workers: int
    seed: int = 0
    drops: tuple = ()        # DropFault...
    grad_faults: tuple = ()  # GradFault...
    wire_faults: tuple = ()  # WireFault...
    stalls: tuple = ()       # StallFault...  (host-side)
    crashes: tuple = ()      # CrashFault...  (host-side)
    # device copies of the flags, masks and wire sites, made once each
    _cache: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    def __post_init__(self):
        for f in self.drops + self.grad_faults + self.stalls:
            if not 0 <= f.worker < self.n_workers:
                raise ValueError(
                    f"fault worker {f.worker} out of range "
                    f"[0, {self.n_workers})")
        for f in (self.drops + self.grad_faults + self.wire_faults
                  + self.stalls + self.crashes):
            if f.stop <= f.start:
                raise ValueError(f"empty fault step range "
                                 f"[{f.start}, {f.stop})")
        for f in self.stalls:
            if f.ms <= 0:
                raise ValueError(f"stall needs ms > 0, got {f.ms}")

    def _on_device(self, key, device, make) -> torch.Tensor:
        """``make()`` (a numpy array) copied to ``device`` once per key."""
        key = (key, str(device))
        if key not in self._cache:
            self._cache[key] = torch.from_numpy(make()).to(device)
        return self._cache[key]

    # ------------------------------------------------------------- drops
    def drop_mask(self, step: int) -> np.ndarray:
        """``[n_workers]`` bool, False where a drop fault is active at
        ``step`` (ANDed into the participation mask by the optimizer)."""
        mask = np.ones(self.n_workers, dtype=bool)
        for f in self.drops:
            if f.start <= step < f.stop:
                mask[f.worker] = False
        return mask

    # ----------------------------------------------------------- grads
    def inject_grads(self, grads: list, step: int) -> list:
        """Poison the scheduled gradient leaves of the per-leaf list of
        worker-lead grads (``[n_workers, ...]``, in the reference's leaf
        order). The faulty leaf index is drawn from the plan seed per
        fault, as the reference draws it."""
        if not self.grad_faults:
            return grads
        grads = list(grads)
        rng = np.random.default_rng(self.seed)
        for fi, f in enumerate(self.grad_faults):
            lid = f.leaf_id if f.leaf_id >= 0 \
                else int(rng.integers(len(grads)))
            g = grads[lid]
            active = f.start <= step < f.stop
            sel = self._on_device(
                ("grad", fi, active), g.device,
                lambda: np.arange(self.n_workers) == f.worker if active
                else np.zeros(self.n_workers, dtype=bool))
            poison = float("nan") if f.mode == "nan" else float("inf")
            grads[lid] = torch.where(
                sel.reshape((-1,) + (1,) * (g.ndim - 1)), poison, g)
        return grads

    # ------------------------------------------------------------ wire
    def inject_wire(self, buf: torch.Tensor, step: int, stage: int = 0,
                    direction: str = "w2s") -> torch.Tensor:
        """XOR seeded byte positions of a gathered u8 wire (sub-)buffer
        (``[n_workers, nbytes]``, in place) when a wire fault is active.
        Positions and masks are drawn per (fault, stage, direction), as
        the reference draws them, so staged arms corrupt independent
        sites; at most the buffer's bytes per row."""
        if not self.wire_faults or direction != "w2s" \
                or buf.dtype != torch.uint8:
            return buf
        nbytes = buf.shape[-1]
        for fi, f in enumerate(self.wire_faults):
            rng = np.random.default_rng(
                (self.seed, fi, stage, 0 if direction == "w2s" else 1))
            n = min(f.n_bits, nbytes)
            pos = rng.choice(nbytes, size=n, replace=False)
            xor = rng.integers(1, 256, size=n).astype(np.uint8)
            key = ("wire", fi, stage, nbytes)
            pos_t = self._on_device(key + ("pos",), buf.device,
                                    lambda: pos.astype(np.int64))
            xor_t = self._on_device(key + ("xor",), buf.device, lambda: xor)
            active = self._on_device(
                ("flag", f.start <= step < f.stop), buf.device,
                lambda: np.asarray(f.start <= step < f.stop))
            sites = buf[..., pos_t]
            buf[..., pos_t] = torch.where(active, sites ^ xor_t, sites)
        return buf

    def active_any(self, step: int) -> bool:
        """Any declared fault active at ``step``."""
        return any(f.start <= step < f.stop for f in
                   self.drops + self.grad_faults + self.wire_faults
                   + self.stalls + self.crashes)

    # ------------------------------------------------- host-side faults
    def stall_ms(self, step: int, attempt: int = 0) -> int:
        """Milliseconds a ``stall`` clause delays host step ``step``
        (0 when none active). Only attempt 0 stalls: the fault models a
        transiently wedged worker, so the supervisor's retry dispatch
        goes through clean."""
        if attempt != 0:
            return 0
        return max((f.ms for f in self.stalls
                    if f.start <= step < f.stop), default=0)

    def host_stall(self, step: int, attempt: int = 0) -> int:
        """Sleep out any active stall fault; returns the ms slept."""
        ms = self.stall_ms(step, attempt)
        if ms:
            time.sleep(ms / 1000.0)
        return ms

    def host_crash(self, step: int, start_step: int = 0) -> None:
        """Hard process exit (``os._exit(CRASH_EXIT)``) when a ``crash``
        clause matches ``step`` — simulated power loss, no atexit/flush.
        Gated on ``start_step == 0`` so a ``--resume`` run (which starts
        past step 0) replays the same schedule without re-crashing."""
        if start_step != 0:
            return
        for f in self.crashes:
            if f.step == step:
                os._exit(CRASH_EXIT)


def parse_faults(spec: str, n_workers: int, seed: int = 0) -> FaultPlan:
    """Parse the CLI fault grammar (module docstring) into a FaultPlan."""
    drops, grads, wires, stalls, crashes = [], [], [], [], []
    for clause in [c.strip() for c in spec.split(",") if c.strip()]:
        m = _CLAUSE_RE.match(clause)
        if not m:
            raise ValueError(f"bad fault clause {clause!r}")
        kind = m.group(1)
        kv = dict(p.split("=", 1) for p in m.group(2).split(":") if p)
        if kind == "crash":
            if "step" not in kv:
                raise ValueError(f"fault clause {clause!r} needs step=s")
            crashes.append(CrashFault(int(kv["step"])))
            continue
        if "steps" not in kv:
            raise ValueError(f"fault clause {clause!r} needs steps=a[-b]")
        a, _, b = kv["steps"].partition("-")
        start, stop = int(a), (int(b) if b else int(a) + 1)
        if kind == "drop":
            drops.append(DropFault(int(kv["w"]), start, stop))
        elif kind in ("nan", "inf"):
            grads.append(GradFault(int(kv["w"]), start, stop, kind,
                                   leaf_id=int(kv.get("leaf", -1))))
        elif kind == "stall":
            stalls.append(StallFault(int(kv["w"]), start, stop,
                                     ms=int(kv.get("ms", 1000))))
        else:  # flip
            wires.append(WireFault(start, stop,
                                   n_bits=int(kv.get("bits", 8))))
    return FaultPlan(n_workers=n_workers, seed=seed, drops=tuple(drops),
                     grad_faults=tuple(grads), wire_faults=tuple(wires),
                     stalls=tuple(stalls), crashes=tuple(crashes))
