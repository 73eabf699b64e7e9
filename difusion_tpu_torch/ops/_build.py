"""Build, bind and count the port's CUDA kernels.

Every ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library with a
plain C interface under ``build/`` at the repo root (listed in
``.gitignore``), at first use, keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags.
All sources compile in parallel (one ``nvcc`` process each).  Libraries load
with ``ctypes``; pointers and the stream pass as ``c_void_p``.  Each C entry
point returns ``cudaGetLastError()`` after its launch and :func:`check`
raises on a nonzero code: a refused launch never silently falls back.

Each kernel wrapper calls :func:`count_launch` once per kernel launch, so a
run can show that its main path went through the kernels.  A launch that is
recorded into a CUDA graph (``utils/cudagraph.py``) is counted by the graph's
owner instead: the calls made while it captures go to :func:`recording`'s
dictionary, and the owner adds them once for every time the device ran that
part of the graph, through a function it registers with :func:`add_flusher`.
The counts are safe to update from several threads (the mesher's worker
launches kernel 3 while the main thread may capture a graph): a thread's
launches go to its own recording, if it has one, else to the totals under a
lock.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "difusion_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_launches: Dict[str, int] = {}
_lock = threading.RLock()
# per thread: while it captures a graph, count_launch writes to the
# innermost of its recordings
_local = threading.local()
# bound methods (held weakly) that add the launches graph replays have made
_flushers: List[weakref.WeakMethod] = []
# per source: wall seconds of its nvcc run and the ptxas resource report
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine "
                       "with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    """Keyed by the source, every csrc/*.cuh (any of them may be included)
    and the flags, so an edited header rebuilds its libraries."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build_all() -> Dict[str, dict]:
    """Compile every csrc/*.cu not yet built, all nvcc processes at once.
    Raises if any compile fails."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not _lib_path(n).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            out = _lib_path(n)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        failed = []
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_info[n] = {"seconds": time.perf_counter() - t0,
                             "ptxas": [ln.strip() for ln in log.splitlines()
                                       if "Used" in ln or "spill" in ln
                                       or "Compiling entry" in ln or "wgmma" in ln]}
            if proc.returncode != 0:
                failed.append(f"{n}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return build_info


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu's library (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def launch_on(index: int, fn, *args) -> int:
    """``fn(*args, stream)`` with card ``index``'s current stream, while that
    card is current (entered only when another one is): a C launcher
    launches on the current card.  The raw getter skips building a Stream
    object on every call."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream
    if index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)


def _recordings() -> List[Dict[str, int]]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def count_launch(name: str, n: int = 1) -> None:
    stack = _recordings()
    if stack:
        stack[-1][name] = stack[-1].get(name, 0) + n
        return
    with _lock:
        _launches[name] = _launches.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """The launches this thread counts inside the block, kept out of the
    totals: what one pass of a graph under capture will launch at every
    replay."""
    rec: Dict[str, int] = {}
    stack = _recordings()
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.pop()


def add_flusher(method) -> None:
    """Register a bound method that, when called, counts (through
    :func:`count_launch`) the launches its object's graph replays have made
    since it was last called.  Held weakly."""
    with _lock:
        _flushers.append(weakref.WeakMethod(method))


def _flush() -> None:
    with _lock:
        alive = []
        for ref in _flushers:
            method = ref()
            if method is not None:
                method()
                alive.append(ref)
        _flushers[:] = alive


def launch_counts() -> Dict[str, int]:
    with _lock:
        _flush()
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        _flush()
        _launches.clear()
