"""Trace spans: names for the step's phase structure (DESIGN.md §10).

Port of ``repro/obs/trace.py``. Two span kinds, one naming convention:

* ``phase_span(name, on)`` wraps a block of the optimizer step. On, it
  opens ``torch.profiler.record_function(name)`` (a range that a
  ``torch.profiler`` capture shows, and that the kernels launched inside
  it can be attributed to) and, with ``nvtx``, an NVTX range; off, it is
  a ``contextlib.nullcontext``, so the spans-off step runs exactly the
  code it ran without this module.
* ``span(name)`` times a host phase (checkpoint I/O, plan builds) into
  the process-wide ``SpanRecorder`` and marks it as a ``record_function``
  range too. ``span_summary()`` gives the recorder as rows for the
  metrics sink and the train CLI's end-of-run table.

Span names are the reference's, letter for letter: ``PHASE_SPANS`` for
the five phases of ``core/muon.py``, and ``wire_stage_span(direction,
k)`` for stage ``k``'s gather or broadcast.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict

import torch

# The five algorithm phases of EF21-Muon (core/muon.py, DESIGN.md §5),
# in dataflow order. One span per phase, staged or monolithic.
PHASE_SPANS = (
    "ef21/p1_s2w_update",    # EF21-P model estimate + s2w broadcast
    "ef21/p2_grads",         # per-worker grads at W (no comm)
    "ef21/p3_ef_compress",   # momentum + EF21 compress R_j = C_D(M_j-G_j)
    "ef21/p4_wire_recv",     # payload gathers issued + server receive
    "ef21/p5_lmo",           # layer-wise LMO (bucketed Newton-Schulz)
)


def wire_stage_span(direction: str, k: int) -> str:
    """Span name of stage ``k``'s u8 collective: ``direction`` is
    ``"w2s"`` (payload all-gather) or ``"s2w"`` (update broadcast)."""
    if direction not in ("w2s", "s2w"):
        raise ValueError(f"direction must be w2s|s2w, got {direction!r}")
    return f"wire/{direction}/stage{k}"


@contextlib.contextmanager
def _range(name: str, nvtx: bool):
    with torch.profiler.record_function(name):
        if not nvtx:
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def phase_span(name: str, on: bool, nvtx: bool = False):
    """Span around a block of the step: ``record_function`` (plus an NVTX
    range with ``nvtx``, for a step on a CUDA device) when ``on``, a
    ``nullcontext`` otherwise."""
    return _range(name, nvtx) if on else contextlib.nullcontext()


class SpanRecorder:
    """Thread-safe accumulator of host-side span wall times."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: OrderedDict[str, list] = OrderedDict()

    def record(self, name: str, dur_s: float) -> None:
        with self._lock:
            ent = self._spans.setdefault(name, [0, 0.0, 0.0])
            ent[0] += 1
            ent[1] += dur_s
            ent[2] = max(ent[2], dur_s)

    def summary(self) -> list[dict]:
        """One row per span name (insertion order): count / total / max."""
        with self._lock:
            return [{"name": n, "count": c, "total_s": round(t, 6),
                     "max_s": round(mx, 6)}
                    for n, (c, t, mx) in self._spans.items()]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


# Process-wide recorder: host phases are rare (checkpoint I/O, plan
# builds) and the CLI summary wants them all in one place. Tests clear it
# around themselves.
RECORDER = SpanRecorder()


@contextlib.contextmanager
def span(name: str, recorder: SpanRecorder | None = None):
    """Wall-time a host phase into the recorder, and mark it as a
    ``record_function`` range so profiler captures see it too."""
    rec = RECORDER if recorder is None else recorder
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        try:
            yield
        finally:
            rec.record(name, time.perf_counter() - t0)


def span_summary(recorder: SpanRecorder | None = None) -> list[dict]:
    return (RECORDER if recorder is None else recorder).summary()
