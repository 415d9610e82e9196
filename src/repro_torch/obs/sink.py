"""Metrics sink: schema-versioned JSONL (DESIGN.md §10).

Port of ``repro/obs/sink.py`` without the benchmark artifacts
(``write_bench_artifact``, ``validate_bench_file``: ROADMAP Queue 1 item
10). One record schema, the reference's, so a file the port writes
passes the reference's validator and the other way round.

Envelope (every record is one JSON object per line):

    {"schema": "repro.metrics/v1", "kind": <kind>, ...kind fields...}

Kinds and their required fields (``validate_record``):

    manifest  config_hash:str, mesh, git_rev     — run header, written
              first (plus torch/schema versions, argv)
    step      step:int, loss:number              — one training step;
              optional metrics:{name: number} from MetricSet
    span      name:str, count:int, total_s:num   — host span summary row
    summary   spans:list[span]                   — end-of-run rollup;
              optional ef_summary rows
    dryrun    arch/shape/mesh/tag:str, status    — the reference's
              dry-run rows
    bench     bench:str                          — benchmark rows
    lint      rule/cell/level/message:str        — lint findings
    recovery  step:int, event:str, attempt:int  — supervisor recovery
              events (§13): event in {start, resume, timeout, retry,
              reload, checkpoint, gave_up}

Legacy rows (no ``schema`` key) validate structurally: the kind is
inferred (``bench`` key => bench, arch/shape/mesh/tag => dryrun).

The writer is async: records go to a queue, a daemon thread writes them
and flushes every ``flush_every`` records (and on close), so the
training loop never blocks on file I/O. Values may be 0-d tensors or
numpy scalars; they are converted in the caller before queueing.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import subprocess
import sys
import threading
import time
import warnings

import torch

SCHEMA = "repro.metrics/v1"

_NUM = (int, float)

# kind -> {field: type-check}; a check is a type tuple or a callable
REQUIRED: dict[str, dict] = {
    "manifest": {"config_hash": str, "mesh": object, "git_rev": object},
    "step": {"step": int, "loss": _NUM},
    "span": {"name": str, "count": int, "total_s": _NUM},
    "summary": {"spans": list},
    "dryrun": {"arch": str, "shape": str, "mesh": str, "tag": str,
               "status": str},
    "bench": {"bench": str},
    "lint": {"rule": str, "cell": str, "level": str, "message": str},
    "recovery": {"step": int, "event": str, "attempt": int},
}


class SchemaError(ValueError):
    pass


def _infer_kind(rec: dict) -> str | None:
    """Kind of a legacy (pre-envelope) record, or None."""
    if "bench" in rec:
        return "bench"
    if all(k in rec for k in ("arch", "shape", "mesh", "tag")):
        return "dryrun"
    return None


def validate_record(rec, kind: str | None = None) -> str:
    """Validate one record; returns its kind. Raises SchemaError."""
    if not isinstance(rec, dict):
        raise SchemaError(f"record must be a dict, got {type(rec).__name__}")
    enveloped = "schema" in rec
    if enveloped and rec["schema"] != SCHEMA:
        raise SchemaError(f"unknown schema {rec['schema']!r}")
    # "kind" is the envelope discriminator only on schema-stamped
    # records; legacy rows may use it as a plain domain field (the
    # committed ns bench rows do), so there it never drives or fights
    # the structural inference.
    k = kind or (rec.get("kind") if enveloped else None) or _infer_kind(rec)
    if k is None:
        raise SchemaError(f"cannot infer record kind: keys={sorted(rec)[:8]}")
    if k not in REQUIRED:
        raise SchemaError(f"unknown kind {k!r}")
    if enveloped and "kind" in rec and rec["kind"] != k:
        raise SchemaError(f"kind mismatch: {rec['kind']!r} != {k!r}")
    for field, want in REQUIRED[k].items():
        if field not in rec:
            raise SchemaError(f"{k} record missing {field!r}")
        if want is not object and not isinstance(rec[field], want):
            raise SchemaError(
                f"{k}.{field} has type {type(rec[field]).__name__}")
    if k == "step" and "metrics" in rec:
        m = rec["metrics"]
        if not isinstance(m, dict) or not all(
                isinstance(n, str) and isinstance(v, _NUM)
                for n, v in m.items()):
            raise SchemaError("step.metrics must map str -> number")
    try:
        json.dumps(rec)
    except TypeError as e:
        raise SchemaError(f"{k} record not JSON-serializable: {e}") from e
    return k


def validate_jsonl(path: str) -> dict:
    """Validate every line of a JSONL sink file; returns per-kind counts.
    Raises SchemaError with the offending line number."""
    counts: dict[str, int] = {}
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise SchemaError(f"{path}:{ln}: bad JSON: {e}") from e
            try:
                k = validate_record(rec)
            except SchemaError as e:
                raise SchemaError(f"{path}:{ln}: {e}") from e
            counts[k] = counts.get(k, 0) + 1
    return counts


# ----------------------------------------------------------------- manifest

def git_rev(root: str | None = None) -> str | None:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=root,
            capture_output=True, text=True, timeout=5,
        ).stdout.strip() or None
    except Exception:
        return None


def config_hash(cfg) -> str:
    """Stable short hash of any config-ish object (dataclass repr)."""
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:12]


def run_manifest(config=None, mesh=None, extra: dict | None = None) -> dict:
    """The run-header record: config hash + mesh shape + git rev (plus
    the torch version and argv so a sink file is self-describing)."""
    rec = {
        "config_hash": config_hash(config) if config is not None else "",
        "config": repr(config) if config is not None else None,
        "mesh": (dict(zip(mesh.axis_names,
                          (int(mesh.shape[a]) for a in mesh.axis_names)))
                 if hasattr(mesh, "axis_names") else mesh),
        "git_rev": git_rev(),
        "torch_version": torch.__version__,
        "argv": list(sys.argv),
    }
    if extra:
        rec.update(extra)
    return rec


# ------------------------------------------------------------------- writer

def _jsonable(value):
    """Host-convert scalars (0-d tensors and numpy arrays included) for
    JSON."""
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, bool) or value is None \
            or isinstance(value, (int, float, str)):
        return value
    if hasattr(value, "item"):        # 0-d tensor / numpy array
        v = value.item()
        return float(v) if isinstance(v, float) else v
    if hasattr(value, "tolist"):
        return value.tolist()
    return str(value)


class MetricsWriter:
    """Schema-validated JSONL sink with an async flush thread.

    >>> with MetricsWriter(path, manifest=run_manifest(cfg, mesh)) as w:
    ...     w.write("step", step=0, loss=3.2, metrics=ms.host_floats())

    ``flush_every`` bounds the records buffered before an fsync-free
    file flush; close() drains the queue. ``append=True`` (the dry-run's
    resumable log) skips the manifest unless one is passed explicitly.

    Transient ``OSError`` during the drain (full disk, flaky NFS) is
    retried ``write_retries`` times with exponential backoff starting at
    ``retry_backoff_s``; a record that still fails is DROPPED and counted
    in ``self.dropped`` — a flaky sink degrades to a lossy one instead of
    silently killing the drain thread (close() warns, never raises, on
    drops). Non-OSError failures keep the old surface-on-close contract.
    """

    def __init__(self, path: str, manifest: dict | None = None,
                 flush_every: int = 20, append: bool = False,
                 write_retries: int = 3, retry_backoff_s: float = 0.05):
        self.path = path
        self.flush_every = max(1, int(flush_every))
        self.write_retries = max(0, int(write_retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self.dropped = 0
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._file = open(path, "a" if append else "w")
        self._queue: queue.Queue = queue.Queue()
        self._err: list = []
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()
        self._closed = False
        if manifest is not None:
            self.write("manifest", **manifest)

    # -- producer side
    def write(self, kind: str, **fields) -> None:
        rec = {"schema": SCHEMA, "kind": kind}
        rec.update(_jsonable(fields))
        validate_record(rec, kind=kind)   # fail in the caller, not the thread
        self._queue.put(rec)

    def write_record(self, rec: dict) -> None:
        rec = dict(_jsonable(rec))
        rec.setdefault("schema", SCHEMA)
        rec.setdefault("kind", validate_record(rec))
        validate_record(rec)
        self._queue.put(rec)

    # -- consumer side
    def _write_one(self, rec: dict) -> bool:
        """One record with bounded retry on transient OSError; returns
        False when the record was dropped (retries exhausted)."""
        delay = self.retry_backoff_s
        for attempt in range(self.write_retries + 1):
            try:
                self._file.write(json.dumps(rec) + "\n")
                return True
            except OSError:
                if attempt == self.write_retries:
                    self.dropped += 1
                    return False
                time.sleep(delay)
                delay *= 2
        return False   # unreachable

    def _drain(self) -> None:
        pending = 0
        while True:
            rec = self._queue.get()
            if rec is None:
                break
            try:
                if self._write_one(rec):
                    pending += 1
                if pending >= self.flush_every or self._queue.empty():
                    try:
                        self._file.flush()
                    except OSError:
                        pass   # flush retries implicitly on next record
                    pending = 0
            except Exception as e:   # surface on close, never in-loop
                self._err.append(e)

    def flush(self) -> None:
        # barrier: wait until the drain thread has emptied the queue
        while not self._queue.empty():
            threading.Event().wait(0.005)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=10)
        try:
            self._file.flush()
        except OSError:
            pass
        self._file.close()
        if self.dropped:
            warnings.warn(
                f"MetricsWriter dropped {self.dropped} record(s) to "
                f"{self.path} after {self.write_retries} retries",
                RuntimeWarning, stacklevel=2)
        if self._err:
            raise self._err[0]

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
