"""The camera frame's packed buffer, made on the device from the camera's
own arrays.

:func:`~.core.tracker.pack_frame` turns a frame's uint8 RGB and uint16
depth into the (h, 3w) uint8 planes ``[intensity | depth low byte | depth
high byte]`` the tracker unpacks, in numpy on the host.  Here the same
planes come from the raw arrays after one upload of them:
:class:`RawFrames` copies K frames' arrays into one host buffer (pinned on
the card), :meth:`RawFrames.pack` uploads it and packs it on the current
stream through :func:`frame_pack`.  On CUDA tensors :func:`frame_pack`
launches the hand-written kernel of ``csrc/frame_pack.cu`` (one launch for
all K frames, counted as ``frame_pack``); on CPU tensors it runs
:func:`frame_pack_plain`.  Both equal ``pack_frame(rgb, depth, dcam_scale)``
byte for byte wherever :func:`takes` the frame: uint8 (h, w, 3) RGB, uint16
(h, w) depth, and the tracker's quantized packing (not
``lossless_packing``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

ALIGN = 16          # the depth block's offset in a RawFrames buffer


def takes(rgb: np.ndarray, depth: np.ndarray, lossless: bool) -> bool:
    """Whether the frame packs on the device: the camera's uint8 (h, w, 3)
    RGB and uint16 (h, w) depth, packed quantized."""
    return (not lossless and isinstance(rgb, np.ndarray) and isinstance(depth, np.ndarray)
            and rgb.dtype == np.uint8 and depth.dtype == np.uint16
            and rgb.ndim == 3 and rgb.shape[2] == 3 and depth.shape == rgb.shape[:2])


def frame_pack_plain(rgb: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(..., h, w, 3) uint8 RGB and (..., h, w) depth (uint16 bits held as
    int16) -> (..., h, 3w) uint8 planes: ``(r + g + b + 1) // 3``, the
    depth's low byte, its high byte."""
    s = rgb.to(torch.int32).sum(dim=-1)
    d = depth.to(torch.int32) & 0xFFFF
    return torch.cat([((s + 1) // 3).to(torch.uint8), (d & 0xFF).to(torch.uint8),
                      (d >> 8).to(torch.uint8)], dim=-1)


_lib = None


def _load():
    """csrc/frame_pack.cu's library, its entry point typed once per process."""
    global _lib
    if _lib is None:
        lib = _build.load("frame_pack")
        p = ctypes.c_void_p
        lib.frame_pack_launch.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int, p]
        lib.frame_pack_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def frame_pack(rgb: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(K, h, w, 3) uint8 RGB and (K, h, w) int16 depth bits -> (K, h, 3w)
    uint8 planes.  CUDA tensors (contiguous, one card) launch
    ``csrc/frame_pack.cu`` once on the current stream, or raise; CPU
    tensors run :func:`frame_pack_plain`."""
    if not rgb.is_cuda:
        return frame_pack_plain(rgb, depth)
    if (rgb.dtype != torch.uint8 or depth.dtype != torch.int16 or rgb.dim() != 4
            or rgb.shape[3] != 3 or depth.shape != rgb.shape[:3] or depth.device != rgb.device
            or not (rgb.is_contiguous() and depth.is_contiguous())
            or 3 * depth.numel() >= 2 ** 31):
        raise ValueError("frame_pack: needs contiguous (K, h, w, 3) uint8 RGB and (K, h, w) "
                         "int16 depth on one card, 3 K h w < 2^31; got "
                         f"{rgb.dtype} {tuple(rgb.shape)} on {rgb.device}, {depth.dtype} "
                         f"{tuple(depth.shape)} on {depth.device}")
    k, h, w = depth.shape
    out = torch.empty((k, h, 3 * w), dtype=torch.uint8, device=rgb.device)
    if out.numel() == 0:
        return out
    err = _build.launch_on(rgb.device.index, _load().frame_pack_launch, rgb.data_ptr(),
                           depth.data_ptr(), out.data_ptr(), depth.numel(), w)
    _build.check(err, "frame_pack")
    _build.count_launch("frame_pack")
    return out


class RawFrames:
    """K frames' camera arrays in one host buffer, pinned for the card:
    the RGB block (K, h, w, 3) uint8, then at the next multiple of
    :data:`ALIGN` bytes the depth block (K, h, w) uint16."""

    def __init__(self, k: int, h: int, w: int, pin: bool):
        self.shape = (k, h, w)
        n = k * h * w
        self.offset = -(-3 * n // ALIGN) * ALIGN
        self.buf = torch.empty(self.offset + 2 * n, dtype=torch.uint8, pin_memory=pin)
        host = self.buf.numpy()
        self._rgb = host[:3 * n].reshape(k, h, w, 3)
        self._depth = host[self.offset:].view(np.uint16).reshape(k, h, w)

    def put(self, i: int, rgb: np.ndarray, depth: np.ndarray) -> None:
        """Copy frame ``i``'s arrays in (any strides, read-only or not)."""
        np.copyto(self._rgb[i], rgb, casting="no")
        np.copyto(self._depth[i], depth, casting="no")

    def pack(self, device, n: int = -1) -> torch.Tensor:
        """Upload the buffer (non-blocking from pinned memory) and pack its
        first ``n`` frames (all by default) on the current stream ->
        (n, h, 3w) uint8 on ``device``."""
        k, h, w = self.shape
        n = k if n < 0 else n
        buf = self.buf.to(device, non_blocking=True)
        rgb = buf[:3 * n * h * w].view(n, h, w, 3)
        depth = buf[self.offset:self.offset + 2 * n * h * w].view(torch.int16).view(n, h, w)
        return frame_pack(rgb, depth)
