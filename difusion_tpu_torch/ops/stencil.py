"""Window-statistics stencil: kernel 2 of the port.

Counterpart of difusion_tpu/ops/stencil_pallas.py:27-88 (``window_stat_sums``)
and of the JAX default ``scan`` backend of ``core/tracker._window_stats``
(tracker.py:316-350), which compute the same function.  Two entries run the
hand-written CUDA kernel ``csrc/window_stats.cu`` on CUDA tensors and
:func:`window_stat_sums_plain` on CPU tensors: :func:`window_stat_sums` takes
the four masked planes and returns 11 maps; :func:`window_stat_sums_map` takes
the (H, W, 3) point map with its bool validity map, masks as the kernel loads,
and returns one (11, H, W) tensor.  On finite inputs the kernel's 11 planes
are bit-equal to the plain version's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import _build

# single-rounded operations the function needs.  Per tap and pixel: d (3
# sub), |d|^2 (3 mul + 2 add), two threshold tests, 11 accumulating adds.  Per
# pixel: ok*{x, y, z} and the six second-moment products, which depend on the
# neighbour alone (wherever a tap's weight is not 0 it equals ok).
OPS_PER_TAP = 21
OPS_PER_PIXEL = 9
# the plain version makes the 9 products anew at every tap: 30 operations a
# tap, the count the kernel's bound was stated with before its redesign
OPS_PER_TAP_PLAIN = 30

# the kernel's tiling (csrc/window_stats.cu): a thread owns R vertically
# adjacent pixels, a warp 32 adjacent columns, a block 4 warps stacked
# vertically (one for each scheduler of an SM) on a 32 x 4R tile
TILE_W = 32
WARPS = 4
ROWS = (1, 5)               # the R the library is built with
# executed instructions of the kernel: per tap and centre (3 sub, 3 mul + 2 add,
# 2 compares, 11 predicated adds), and per loaded neighbour (1 load, 9
# products, ~3 of loop)
_TAP_INSTR = 21
_NEIGHBOUR_INSTR = 13


class Plan(NamedTuple):
    """How :func:`plan` cuts an image into blocks."""
    rows: int               # pixels a thread owns (R)
    tile_h: int             # 4R
    grid: Tuple[int, int]   # blocks along x, along y
    blocks_per_sm: int      # on the busiest SM
    busiest_over_mean: float  # pixel slots of the busiest SM over H*W / SMs


@functools.lru_cache(maxsize=None)
def plan(h: int, w: int, window: int, n_sm: int) -> Plan:
    """The rows per thread that give the busiest SM the fewest executed
    instructions: blocks are dealt one to an SM, so an SM's schedulers each
    run ceil(blocks / n_sm) warps of R pixels a lane, and a warp's cost is
    its (2w+1) * (R + 2w) loaded neighbours plus its R * (2w+1)^2 taps.
    Ties go to the larger R (fewer loads).  The kernel takes no strip longer
    than the window (R <= 2w+1).  The model (an SM runs its blocks one after
    another) is checked against the card's times by ``stencil_tune.py``."""
    side = 2 * window + 1
    best = None
    for r in [r for r in ROWS if r <= side]:
        grid = (-(-w // TILE_W), -(-h // (WARPS * r)))
        per_sm = -(-(grid[0] * grid[1]) // n_sm)
        cost = per_sm * side * (_NEIGHBOUR_INSTR * (r + 2 * window) + _TAP_INSTR * r * side)
        if best is None or cost <= best[0]:
            best = (cost, r, grid, per_sm)
    _, r, grid, per_sm = best
    slots = per_sm * TILE_W * WARPS * r
    return Plan(r, WARPS * r, grid, per_sm, slots * n_sm / (h * w))


def window_stat_sums_plain(px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor,
                           vf: torch.Tensor, window: int, outlier_r2: float,
                           normal_r2: float) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: a loop over the (2w+1)^2 offsets of the
    zero-padded maps in the scan's order (dv outer, du inner)."""
    h, w = px.shape
    pads = (window,) * 4
    ppx, ppy, ppz, pvf = (F.pad(a, pads) for a in (px, py, pz, vf))
    zero = torch.zeros((), dtype=px.dtype, device=px.device)
    acc = [torch.zeros_like(px) for _ in range(11)]
    for dv in range(2 * window + 1):
        for du in range(2 * window + 1):
            nx = ppx[dv:dv + h, du:du + w]
            ny = ppy[dv:dv + h, du:du + w]
            nz = ppz[dv:dv + h, du:du + w]
            nok = pvf[dv:dv + h, du:du + w]
            dx, dy, dz = nx - px, ny - py, nz - pz
            d2 = dx * dx + dy * dy + dz * dz
            wgt = torch.where(d2 <= normal_r2, nok, zero)
            upd = (torch.where(d2 <= outlier_r2, nok, zero), wgt,
                   wgt * nx, wgt * ny, wgt * nz,
                   wgt * nx * nx, wgt * nx * ny, wgt * nx * nz,
                   wgt * ny * ny, wgt * ny * nz, wgt * nz * nz)
            acc = [a + u for a, u in zip(acc, upd)]
    return tuple(acc)


_lib = None


def _load():
    """csrc/window_stats.cu's library, its entry points typed once per
    process."""
    global _lib
    if _lib is None:
        lib = _build.load("window_stats")
        tail = [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
        lib.window_stats_launch.argtypes = [ctypes.c_void_p] * 5 + tail
        lib.window_stats_map_launch.argtypes = [ctypes.c_void_p] * 3 + tail
        lib.window_stats_launch.restype = ctypes.c_int
        lib.window_stats_map_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_cuda(entry: str, inputs, h: int, w: int, window: int, outlier_r2: float,
                 normal_r2: float, rows=None) -> torch.Tensor:
    """Launch ``entry`` of csrc/window_stats.cu on ``inputs`` (validated by
    the caller) -> the (11, H, W) sums on the current stream, checked and
    counted.  ``rows`` overrides the plan's rows per thread: the card tests
    reach every instantiation with it, no caller of the port sets it."""
    dev = inputs[0].device
    if window < 0 or 3 * h * w >= 2 ** 31:
        raise ValueError(f"window_stat_sums: needs window >= 0 and 3 * H * W < 2^31 (the "
                         f"kernel's pixel indices are 32-bit), got window {window}, "
                         f"{h} x {w}")
    out = torch.empty((11, h, w), dtype=torch.float32, device=dev)
    if h * w == 0:
        return out
    if rows is None:
        rows = plan(h, w, int(window), _n_sm(dev.index)).rows
    elif rows not in ROWS or rows > 2 * window + 1:
        raise ValueError(f"window_stat_sums: rows must be one of {ROWS} and at most "
                         f"2 * window + 1, got {rows} at window {window}")
    fn = getattr(_load(), entry)
    args = (*(t.data_ptr() for t in inputs), out.data_ptr(), h, w, int(window),
            float(outlier_r2), float(normal_r2), int(rows))
    _build.check(_build.launch_on(dev.index, fn, *args), "window_stat_sums")
    _build.count_launch("window_stat_sums")
    return out


def window_stat_sums(px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor,
                     vf: torch.Tensor, window: int, outlier_r2: float,
                     normal_r2: float) -> Tuple[torch.Tensor, ...]:
    """All window reductions in one pass.  Inputs are the UNPADDED (H, W)
    point-component maps, finite and zero where invalid, and the validity map
    as f32 (1.0 valid).  Returns 11 (H, W) f32 maps: (outlier_cnt, cnt, s1x,
    s1y, s1z, sxx, sxy, sxz, syy, syz, szz) -- raw weighted sums.  CUDA
    tensors launch the kernel (or raise); CPU tensors run
    :func:`window_stat_sums_plain`."""
    if not px.is_cuda:
        return window_stat_sums_plain(px, py, pz, vf, window, outlier_r2, normal_r2)
    h, w = px.shape
    for t in (px, py, pz, vf):
        if t.device != px.device or t.dtype != torch.float32 \
                or t.shape != px.shape or not t.is_contiguous():
            raise ValueError("window_stat_sums: px, py, pz, vf must be contiguous "
                             f"float32 ({h}, {w}) tensors on {px.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return _launch_cuda("window_stats_launch", (px, py, pz, vf), h, w, window,
                        outlier_r2, normal_r2).unbind(0)


def window_stat_sums_map(pc_map: torch.Tensor, valid: torch.Tensor, window: int,
                         outlier_r2: float, normal_r2: float) -> torch.Tensor:
    """:func:`window_stat_sums` of ``where(valid, pc_map, 0)`` and
    ``valid.float()``, as one (11, H, W) tensor: the (H, W, 3) f32 point map
    (finite where valid) and the (H, W) bool validity map go to the kernel as
    they are, and it masks while it loads them.  CUDA tensors launch the
    kernel (or raise); CPU tensors run :func:`window_stat_sums_plain`."""
    if not pc_map.is_cuda:
        zero = torch.zeros((), dtype=pc_map.dtype)
        planes = [torch.where(valid, pc_map[..., c], zero) for c in range(3)]
        return torch.stack(window_stat_sums_plain(
            *planes, valid.to(pc_map.dtype), window, outlier_r2, normal_r2))
    h, w = valid.shape
    if pc_map.dtype != torch.float32 or pc_map.shape != (h, w, 3) \
            or valid.dtype != torch.bool or valid.device != pc_map.device \
            or not (pc_map.is_contiguous() and valid.is_contiguous()):
        raise ValueError("window_stat_sums_map: needs a contiguous float32 (H, W, 3) "
                         "point map and a contiguous bool (H, W) map on one device, "
                         f"got {pc_map.dtype} {tuple(pc_map.shape)} on {pc_map.device} "
                         f"and {valid.dtype} {tuple(valid.shape)} on {valid.device}")
    return _launch_cuda("window_stats_map_launch", (pc_map, valid), h, w, window,
                        outlier_r2, normal_r2)
