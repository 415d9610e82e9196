"""Flat-npz checkpoints of nested dicts of tensors and of the optimizer
state (DESIGN.md §11).

Port of ``repro/train/checkpoint.py``, the same archive: one ``.npz``
entry per array under its ``/``-joined key path (``m_w/__none__`` for a
None), a ``__manifest__`` entry holding the CRC32, shape and dtype of
every array, and ``__step__``. The port's EF21-Muon state is written in
the reference's layout (``models.api.state_to_numpy``: the compressor
states as trees shaped like the params, the step as int32), so an
archive written by either package resumes in the other.

  * ``save_checkpoint`` writes to a temp file in the target directory,
    rotates an existing checkpoint to ``<path>.prev`` (a legacy bare-path
    archive counts as that previous generation), publishes with
    ``os.replace`` and fsyncs the directory.
  * ``load_checkpoint`` re-hashes every array against the manifest and
    falls back to ``<path>.prev`` with a warning when the newest
    generation is torn or corrupt. Pre-manifest archives load unchecked.

Over a process group of several ranks (the worker axis,
``dist/sharding.py``) the archive is the same: ``save_checkpoint``
gathers the worker-lead leaves from every rank and rank 0 writes the
one-rank archive, and ``load_checkpoint`` gives each rank its workers'
rows, so a run resumes on any number of ranks that divides its workers.
A server state cut by the zero-1 or FSDP rules is gathered by
``Trainer.save_checkpoint`` before it comes here, and cut again by
``Trainer.load_checkpoint``: the archive is the same bytes.

bf16: numpy has no bf16 dtype of its own. Both packages hold a bf16
array as its 2-byte patterns, and the manifest names it ``bfloat16``.
The reference's numpy (with ``ml_dtypes``) writes its entry's header as
``<V2``, which ``np.load`` gives back as a 2-byte void; the port writes
``bfloat16`` there, which ``np.load`` gives back as bf16 wherever
``ml_dtypes`` is installed, so the reference's ``load_checkpoint`` reads
the port's archive with the bits unchanged. The port reads the headers
itself (no ``np.load``), so it needs no ``ml_dtypes`` for either.
"""
from __future__ import annotations

import ast
import json
import os
import warnings
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.models.api import (array_to_tensor, state_from_jax,
                                    state_layout, state_to_numpy,
                                    tensor_to_array)
from repro_torch.obs.trace import span

_MANIFEST_KEY = "__manifest__"
_STEP_KEY = "__step__"
_BF16 = np.dtype("V2")       # a bf16 array's host form: its 2-byte patterns


class CheckpointError(RuntimeError):
    """A checkpoint file is unreadable or fails its checksum manifest."""


def _is_opt_state(tree: Any) -> bool:
    return isinstance(tree, dict) and isinstance(tree.get("cw_state"), list)


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif tree is None:
        out[prefix + "__none__"] = np.zeros((0,))
    else:
        out[prefix.rstrip("/")] = (tensor_to_array(tree)
                                   if isinstance(tree, torch.Tensor)
                                   else np.asarray(tree))
    return out


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _checksum(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
                      .data)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16 else str(arr.dtype)


def _build_manifest(flat: dict[str, np.ndarray]) -> str:
    return json.dumps({
        k: {"crc32": _checksum(v), "shape": list(v.shape),
            "dtype": _dtype_name(v)}
        for k, v in flat.items()})


def _write_npz(f, flat: dict[str, np.ndarray]) -> None:
    """``np.savez``'s archive (stored members ``<key>.npy``), with bf16
    entries' headers naming ``bfloat16``."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in flat.items():
            # (np.ascontiguousarray would make a 0-d array 1-d)
            arr = arr if arr.flags.c_contiguous else arr.copy(order="C")
            with zf.open(key + ".npy", "w", force_zip64=True) as m:
                if arr.dtype == _BF16:
                    np.lib.format.write_array_header_1_0(m, {
                        "descr": "bfloat16", "fortran_order": False,
                        "shape": arr.shape})
                    m.write(arr.reshape(-1).view(np.uint8).data)
                else:
                    np.lib.format.write_array(m, arr, allow_pickle=False)


def _read_npy(data: bytes) -> np.ndarray:
    """One ``.npy`` member: a 2-byte void array for bf16 (``bfloat16``
    or ``<V2`` in the header), else the header's dtype."""
    if data[:6] != b"\x93NUMPY":
        raise ValueError("not an .npy member")
    major = data[6]
    if major == 1:
        hlen, start = int.from_bytes(data[8:10], "little"), 10
    else:
        hlen, start = int.from_bytes(data[8:12], "little"), 12
    header = ast.literal_eval(data[start:start + hlen].decode("latin1"))
    descr = header["descr"]
    dtype = (_BF16 if descr in ("bfloat16", "<V2", "|V2")
             else np.lib.format.descr_to_dtype(descr))
    if dtype.hasobject:
        raise ValueError("object arrays are not read")
    shape = tuple(header["shape"])
    arr = np.frombuffer(data, dtype=dtype, offset=start + hlen,
                        count=int(np.prod(shape, dtype=np.int64)))
    order = "F" if header["fortran_order"] else "C"
    return arr.reshape(shape, order=order)


def save_checkpoint(path: str, tree: Any, step: int | None = None,
                    group=None, record: list | None = None) -> None:
    """Write ``tree`` (nested dicts of tensors, arrays and None, or the
    port's EF21-Muon state) to ``path`` (``.npz`` appended if missing).
    A state sharded over ``group`` is gathered first (every rank calls
    this; ``record`` gets each all-gather's bytes) and rank 0 writes;
    every rank returns once the archive is in place."""
    with span("ckpt/save"):
        if _is_opt_state(tree):
            tree = state_to_numpy(tree, group=group, record=record)
        try:
            if tree is not None:     # None: a rank of a group other than 0
                _write_archive(path, tree, step)
        finally:
            # every rank returns once rank 0 has written
            if group is not None and group.size() > 1:
                import torch.distributed as dist
                dist.barrier(group=group)


def _write_archive(path: str, tree: Any, step: int | None) -> None:
    flat = _flatten(tree)
    if step is not None:
        flat[_STEP_KEY] = np.asarray(step)
    manifest = _build_manifest(flat)
    flat[_MANIFEST_KEY] = np.frombuffer(
        manifest.encode(), dtype=np.uint8).copy()
    final = _npz_path(path)
    os.makedirs(os.path.dirname(final) or ".", exist_ok=True)
    # temp file in the same directory => os.replace stays a same-
    # filesystem atomic rename; a crash mid-save leaves the previous
    # generation at `final` untouched
    tmp = final + ".tmp"
    try:
        with open(tmp, "wb") as f:
            _write_npz(f, flat)
            f.flush()
            os.fsync(f.fileno())
        if path != final and os.path.exists(path) \
                and not os.path.exists(final):
            # legacy pre-".npz" archive at the bare path: it would
            # shadow `final` on every later load, so it becomes the
            # last-good generation
            os.replace(path, final + ".prev")
        elif os.path.exists(final):
            os.replace(final, final + ".prev")
        os.replace(tmp, final)
        _fsync_dir(os.path.dirname(final) or ".")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _fsync_dir(dirname: str) -> None:
    # the rename lives in the directory: without this a power loss can
    # resurrect the old entry. Best-effort: not every filesystem allows it
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _read_verified(path: str) -> dict[str, np.ndarray]:
    """Load + checksum-verify one npz; raises CheckpointError."""
    try:
        with zipfile.ZipFile(path) as zf:
            flat = {n[:-len(".npy")]: _read_npy(zf.read(n))
                    for n in zf.namelist() if n.endswith(".npy")}
    except Exception as e:  # bad zip / truncation / unreadable entry
        raise CheckpointError(f"{path}: unreadable checkpoint: {e}") from e
    raw = flat.pop(_MANIFEST_KEY, None)
    if raw is None:
        return flat    # pre-manifest checkpoint: nothing to verify
    try:
        manifest = json.loads(raw.tobytes().decode())
    except Exception as e:
        raise CheckpointError(f"{path}: corrupt manifest: {e}") from e
    if set(manifest) != set(flat):
        raise CheckpointError(
            f"{path}: manifest/content key mismatch: "
            f"{sorted(set(manifest) ^ set(flat))[:4]}")
    for k, ent in manifest.items():
        if _checksum(flat[k]) != ent["crc32"]:
            raise CheckpointError(f"{path}: checksum mismatch on {k!r}")
    return flat


def _to_tensor(arr: np.ndarray, like: Any) -> torch.Tensor:
    """An archived array as a tensor of ``like``'s dtype on its device
    (a numpy ``like``: on the CPU), cast as the reference's ``astype``
    would; bf16 patterns keep their bits."""
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    t = array_to_tensor(arr, device)
    if isinstance(like, torch.Tensor):
        want = like.dtype
    else:
        want = torch.from_numpy(np.zeros(0, np.asarray(like).dtype)).dtype
    return t if t.dtype == want else t.to(want)


def load_checkpoint(path: str, like: Any,
                    group=None) -> tuple[Any, int | None]:
    """Restore into the structure of ``like`` (nested dicts of tensors,
    arrays and None, or the port's EF21-Muon state), on its devices;
    with ``group``, the state's worker-lead leaves as this rank's rows.
    Falls back to ``<path>.prev`` if the newest generation is torn or
    corrupt; raises CheckpointError if both fail."""
    with span("ckpt/load"):
        final = _npz_path(path) if not os.path.exists(path) else path
        try:
            flat = _read_verified(final)
        except CheckpointError as e:
            prev = final + ".prev"
            if not os.path.exists(prev):
                raise
            warnings.warn(f"{e}; falling back to last-good {prev}",
                          RuntimeWarning, stacklevel=2)
            flat = _read_verified(prev)
        step = int(flat.pop(_STEP_KEY)) if _STEP_KEY in flat else None

        def rebuild(sub: Any, prefix: str, leaf):
            if isinstance(sub, dict):
                return {k: rebuild(v, f"{prefix}{k}/", leaf)
                        for k, v in sub.items()}
            if sub is None:
                return None
            return leaf(flat[prefix.rstrip("/")], sub)

        if not _is_opt_state(like):
            return rebuild(like, "", _to_tensor), step
        # the reference's layout, read as arrays, then into the port's
        # layout through state_from_jax, each tensor as ``like``'s
        from repro_torch.dist.layerwise import tree_leaves
        ref = rebuild(state_layout(like), "", lambda a, t: a)
        state = state_from_jax(ref, tree_leaves(like["x"])[0].device,
                               group=group)
        return _match_dtypes(state, like), step


def state_template(tree: Any) -> Any:
    """What ``load_checkpoint`` needs of a ``like``: ``tree``'s structure
    with each tensor replaced by an empty one of its dtype on its device,
    so a template holds no memory of the state it stands for."""
    if isinstance(tree, dict):
        return {k: state_template(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [state_template(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return torch.empty(0, dtype=tree.dtype, device=tree.device)
    return tree


def _match_dtypes(state: Any, like: Any) -> Any:
    if isinstance(state, dict):
        return {k: _match_dtypes(v, like[k]) for k, v in state.items()}
    if isinstance(state, list):
        return [_match_dtypes(v, w) for v, w in zip(state, like)]
    if isinstance(state, torch.Tensor) and state.dtype != like.dtype:
        return state.to(like.dtype)
    return state
