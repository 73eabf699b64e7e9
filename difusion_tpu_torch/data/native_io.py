"""ctypes binding of the native PNG decoder (native/frameio.cpp), the port's
own copy of the part of difusion_tpu/data/native_io.py that the sequence
loaders use (``read_png``; the threaded prefetcher is not bound).

The shared library is built on first use with the system toolchain
(g++ -lz) into ``build/difusion_tpu_torch/`` at the repo root, keyed by a
hash of the source, under a per-process temporary name followed by an atomic
rename: processes that build at the same time each write their own file and
the last rename wins, so none loads a half-written library.  Where the build
fails the loaders decode with cv2 instead, and say so in the log: which
decoder reads a PNG is a host-side choice that does not change the frames.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "frameio.cpp"
_BUILD_DIR = _ROOT / "build" / "difusion_tpu_torch"
_lib = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        key = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        path = _BUILD_DIR / f"libframeio_{key}.so"
        if not path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp),
                            str(_SRC), "-lz", "-lpthread"],
                           check=True, capture_output=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        lib.frameio_read_png.restype = ctypes.c_int
        lib.frameio_read_png.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        _lib = lib
    except (subprocess.CalledProcessError, OSError) as e:
        logging.warning("native frameio unavailable (%s); decoding with cv2", e)
        _build_failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def read_png(path: str) -> np.ndarray:
    """Decode a PNG natively: (H, W) uint16/uint8 for gray, (H, W, C) uint8
    otherwise.  Raises ValueError on a format the decoder does not take."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native frameio unavailable")
    w, h, c, d = (ctypes.c_int() for _ in range(4))
    err = lib.frameio_read_png(path.encode(), None, w, h, c, d)
    if err != 0:
        raise ValueError(f"frameio_read_png({path}) failed: {err}")
    buf = np.empty(w.value * h.value * c.value * (d.value // 8), np.uint8)
    err = lib.frameio_read_png(path.encode(), buf.ctypes.data_as(ctypes.c_void_p),
                               w, h, c, d)
    if err != 0:
        raise ValueError(f"frameio_read_png({path}) failed: {err}")
    img = buf.view(">u2").astype(np.uint16) if d.value == 16 else buf
    img = img.reshape(h.value, w.value, c.value)
    return img[:, :, 0] if c.value == 1 else img
