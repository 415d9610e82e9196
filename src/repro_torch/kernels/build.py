"""Build the CUDA sources under ``csrc/`` into shared libraries and load
them with ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into
``build/lib<name>.so`` beside this module (the directory is git-ignored)
with ``nvcc -gencode arch=compute_90a,code=sm_90a``. The sources have a
plain C interface and include no PyTorch header, so a build takes
seconds. A library is rebuilt when its source is newer. Nothing is
fetched: ``nvcc`` comes from ``$CUDA_HOME``, ``PATH`` or
``/usr/local/cuda``.

Every C entry point takes PyTorch's current stream (``stream``) and
returns ``cudaGetLastError()`` right after its launch, which
``check_launch`` turns into an exception.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def compile_source(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``build/lib<name>.so`` unless an
    up-to-date library is there. The library is written to a temporary
    file and renamed, so concurrent builders never load a torn file.
    Returns the library path; raises with nvcc's output on failure."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> list[Path]:
    """Compile every ``csrc/*.cu``, one nvcc per source, all at once."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        futs = [ex.submit(compile_source, n) for n in names]
        return [f.result() for f in futs]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(compile_source(name)))
        return _libs[name]


def stream(device) -> int:
    """PyTorch's current stream on ``device``, as the C entry points take
    it."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(rc: int, what: str) -> None:
    """Raise when a C entry point reports a failed launch."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")
