"""ctypes binding of the native PNG decoder (native/frameio.cpp), the port's
own copy of difusion_tpu/data/native_io.py: ``read_png``, which the sequence
loaders use, and :class:`PngPrefetcher`, the library's threaded
decode-ahead.

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
from typing import List, Optional

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
        lib.frameio_prefetcher_create.restype = ctypes.c_void_p
        lib.frameio_prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.frameio_prefetcher_next.restype = ctypes.c_int
        lib.frameio_prefetcher_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.frameio_prefetcher_destroy.restype = None
        lib.frameio_prefetcher_destroy.argtypes = [ctypes.c_void_p]
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
    return _unpack(buf, w.value, h.value, c.value, d.value)


def _unpack(buf: np.ndarray, w: int, h: int, channels: int, bitdepth: int) -> np.ndarray:
    img = buf.view(">u2").astype(np.uint16) if bitdepth == 16 else buf
    img = img.reshape(h, w, channels)
    return img[:, :, 0] if channels == 1 else img


def _png_header(path) -> bytes:
    """Width, height, bit depth and colour type from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(26)
    if len(head) < 26 or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG")
    return head[16:26]


class PngPrefetcher:
    """Sequential decode-ahead over a list of PNG paths of one size and
    format: the library's worker threads keep ``ring_size`` frames decoded
    in front of the consumer.  :meth:`next` returns the frames in order, as
    :func:`read_png` decodes them, and raises ValueError past the last;
    :meth:`close` (idempotent) stops the threads.  The library copies each
    frame into a buffer sized by the first, so every file's PNG header must
    match the first's (ValueError otherwise)."""

    def __init__(self, paths: List[str], ring_size: int = 8, n_threads: int = 2):
        self._handle = None
        headers = {_png_header(p) for p in paths}
        if len(headers) != 1:
            raise ValueError(f"PngPrefetcher: the PNGs differ in size or format: {headers}")
        lib = _load()
        if lib is None:
            raise RuntimeError("native frameio unavailable")
        self._lib = lib
        # the library reads these strings while its threads run: keep them
        self._paths = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        w, h, c, d = (ctypes.c_int() for _ in range(4))
        err = lib.frameio_read_png(self._paths[0], None, w, h, c, d)
        if err != 0:
            raise ValueError(f"cannot probe {paths[0]}: {err}")
        self._shape = (w.value, h.value, c.value, d.value)
        self._handle = lib.frameio_prefetcher_create(arr, len(self._paths), ring_size,
                                                     n_threads)

    def __len__(self) -> int:
        return len(self._paths)

    def next(self) -> np.ndarray:
        w0, h0, c0, d0 = self._shape
        buf = np.empty(w0 * h0 * c0 * (d0 // 8), np.uint8)
        w, h, c, d = (ctypes.c_int() for _ in range(4))
        err = self._lib.frameio_prefetcher_next(
            self._handle, buf.ctypes.data_as(ctypes.c_void_p), w, h, c, d)
        if err != 0:
            raise ValueError(f"prefetcher_next failed: {err}")
        return _unpack(buf, w.value, h.value, c.value, d.value)

    def close(self) -> None:
        if self._handle:
            self._lib.frameio_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
