"""Sparse marching cubes with cross-block (sdf, std) interpolation
(counterpart of difusion_tpu/ops/marching_cubes.py).

* Each active block evaluated the decoder on a ``2r`` lattice covering the
  voxel plus a half-voxel margin.  Block-corner values blend the overlapping
  lattices of up to 8 neighbouring blocks: trilinear ramp weights times the
  predicted std.  A corner whose *own-block* sample is missing invalidates
  its cubes.
* Per-(block, subcell) triangle emission uses the 256-case tables
  (:mod:`.mc_tables`) and per-vertex std-aware interpolation, pruning
  triangles with any vertex std above ``max_std``.
* Triangles compact by a prefix sum into a fixed ``max_triangles`` buffer
  of 13-float rows (:class:`McResult`): extra triangles are dropped and the
  true count is reported.

:func:`marching_cubes_sparse` launches the hand-written CUDA kernels of
``csrc/marching_cubes.cu`` on CUDA tensors (three launches, counted as
``mc_classify``, ``mc_scan`` and ``mc_emit``) and runs
:func:`marching_cubes_sparse_plain` on CPU tensors; a CUDA tensor never
reaches the plain version through it.  The plain version is every step as a
fixed-shape tensor op in the JAX package's order (the 8 corner choices, the
``sdf_interp`` chain, the 5 triangle slabs), so the triangles come out in
the same order and agree with the JAX package to f32 rounding; the kernels
compute the same arithmetic in the same order and equal it bit for bit.
The numpy-built constant tables upload once per ``(r, device)``.

:func:`mc_splice` turns an extract's chunk buffers into its triangles: the
kept rows of every chunk in chunk order, in world space, with each
triangle's latent slot (:class:`Spliced`).  On CUDA tensors it is one launch
of the same library's splice kernel (counted as ``mc_splice``), on CPU
tensors :func:`mc_splice_plain`, which is the numpy splice the JAX package
runs on the host, in tensor ops, and which the kernel equals bit for bit.
:func:`mc_triangles_np` brings the result to the host: one read of the
count, then one download of each output.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _build
from .mc_tables import CORNER_OFFSETS, EDGE_CORNERS, TRI_TABLE

ROW = 13      # floats a triangle: 9 vertex coordinates, 3 vertex stds, the block id
SLABS = 5     # triangles a cube emits at most


class McResult(NamedTuple):
    """Views of one (T, 13) buffer, ``packed``: a triangle a row, its 9
    vertex coordinates (vertex*3 + coord, voxel units), its 3 vertex stds and
    its linearized block id bit-cast to f32 (-1 padding)."""
    triangles: torch.Tensor   # (9, T) f32: rows = vertex*3 + coord, voxel units
    tri_std: torch.Tensor     # (3, T) f32 per-vertex std
    tri_block: torch.Tensor   # (T,) int32 linearized block id (-1 padding)
    count: torch.Tensor       # () int64 total emitted (may exceed T)
    packed: torch.Tensor      # (T, 13) f32: the buffer the other fields view


def _result(packed: torch.Tensor, count: torch.Tensor) -> McResult:
    return McResult(packed[:, :9].T, packed[:, 9:12].T, packed.view(torch.int32)[:, 12],
                    count, packed)


class Spliced(NamedTuple):
    """An extract's triangles, planar (:func:`mc_splice`): the first
    ``totals[1]`` rows of each output hold them."""
    triangles: torch.Tensor   # (T, 3, 3) f32 world-space vertices
    tri_std: torch.Tensor     # (T, 3) f32 per-vertex std
    tri_slot: torch.Tensor    # (T,) int64 latent slot of the triangle's block
    totals: torch.Tensor      # (2,) int64: survivors emitted (may exceed T), rows kept


def mc_triangles_np(res: Spliced) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host-side unpack -> (world-space tris (T, 3, 3), stds (T, 3), slots
    (T,), survivors emitted): one read of the totals, then one download of
    each output's first T rows, on the current stream, into fresh
    contiguous arrays."""
    emitted, rows = res.totals.tolist()
    return (res.triangles[:rows].cpu().numpy(), res.tri_std[:rows].cpu().numpy(),
            res.tri_slot[:rows].cpu().numpy(), emitted)


def _corner_tables(r: int):
    """Per-dim blending tables for corner index c in [0..r]: for the m/p
    samples give (block offset, lattice index, weight) and which of the two
    is the own-block sample."""
    c = np.arange(r + 1)
    rbound = (r - 1) // 2
    rstart = r // 2
    rmid = r / 2.0
    lower = c <= rbound
    off_m = np.where(lower, -1, 0).astype(np.int32)
    idx_m = np.where(lower, c + rstart + r, c + rstart).astype(np.int32)
    w_m = np.where(lower, (rmid - c) / r, (rmid + r - c) / r).astype(np.float32)
    off_p = np.where(lower, 0, 1).astype(np.int32)
    idx_p = np.where(lower, c + rstart, c + rstart - r).astype(np.int32)
    w_p = np.where(lower, (c + rmid) / r, (c - rmid) / r).astype(np.float32)
    own_is_p = lower  # in the lower branch the own-block sample is 'p'
    return off_m, idx_m, w_m, off_p, idx_p, w_p, own_is_p


def _corner_grid(r: int) -> np.ndarray:
    """((r+1)^3, 3) corner coordinates, x-major."""
    ar = np.arange(r + 1)
    return np.stack(np.meshgrid(ar, ar, ar, indexing="ij"), axis=-1).reshape(-1, 3)


@lru_cache(maxsize=32)
def _blend_consts(r: int, device: torch.device):
    """Per corner choice (cx, cy, cz): block offsets (3, nc), lattice index
    (nc,), weight (nc,) and the own-block flag (nc,), on ``device``; plus the
    own-lattice index of the non-interpolating variant."""
    off_m, idx_m, w_m, off_p, idx_p, w_p, own_is_p = _corner_tables(r)
    off_t, idx_t, w_t = (off_m, off_p), (idx_m, idx_p), (w_m, w_p)
    cgrid = _corner_grid(r)
    side = 2 * r
    choices = []
    for cx in range(2):
        for cy in range(2):
            for cz in range(2):
                choice = (cx, cy, cz)
                off_c = np.stack([off_t[ch][cgrid[:, a]] for a, ch in enumerate(choice)])
                idx_c = [idx_t[ch][cgrid[:, a]] for a, ch in enumerate(choice)]
                w_c = (w_t[cx][cgrid[:, 0]] * w_t[cy][cgrid[:, 1]]
                       * w_t[cz][cgrid[:, 2]])
                lat = (idx_c[0] * side * side + idx_c[1] * side + idx_c[2])
                is_own = np.logical_and.reduce(
                    [own_is_p[cgrid[:, a]] == bool(ch) for a, ch in enumerate(choice)])
                choices.append((torch.from_numpy(off_c.astype(np.int64)).to(device),
                                torch.from_numpy(lat.astype(np.int64)).to(device),
                                torch.from_numpy(w_c).to(device),
                                torch.from_numpy(is_own).to(device)))
    rstart = r // 2
    own_lat = ((cgrid[:, 0] + rstart) * side * side
               + (cgrid[:, 1] + rstart) * side + (cgrid[:, 2] + rstart))
    return choices, torch.from_numpy(own_lat.astype(np.int64)).to(device)


def _block_pos(valid_blocks: torch.Tensor, n_xyz) -> torch.Tensor:
    _, ny, nz = n_xyz
    vb = torch.clamp(valid_blocks, min=0).to(torch.int64)
    return torch.stack([vb // (ny * nz), (vb // nz) % ny, vb % nz], dim=-1)


def _batch_of(slot_to_batch: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """slot_to_batch[slot], where a free slot (-1) reads the table's last
    entry (-1), as the JAX package's clip to -1 and wrap-around does."""
    n = slot_to_batch.shape[0]
    idx = torch.clamp(slot.to(torch.int64), -1, n - 2)
    return slot_to_batch[torch.where(idx < 0, n - 1, idx)]


def corner_field(indexer: torch.Tensor, slot_to_batch: torch.Tensor,
                 valid_blocks: torch.Tensor, cube_sdf: torch.Tensor,
                 cube_std: torch.Tensor, n_xyz: Tuple[int, int, int],
                 r: int, interpolate: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blend block lattices into block-corner values.

    Returns (corner_sdf, corner_std, corner_valid), each (B, r+1, r+1, r+1)
    for B = len(valid_blocks).  ``cube_sdf``/``cube_std`` may hold MORE rows
    than B (``slot_to_batch`` indexes into them): a chunked extract emits
    triangles for a block subset while interpolating corners against every
    evaluated neighbour.  Invalid corners are NaN.
    """
    dev = cube_sdf.device
    B = valid_blocks.shape[0]
    side = 2 * r
    nc = (r + 1) ** 3
    shape4 = (B, r + 1, r + 1, r + 1)
    block_ok = valid_blocks >= 0
    bpos = _block_pos(valid_blocks, n_xyz)                               # (B, 3)
    cube_sdf_f = cube_sdf.reshape(-1, side ** 3)
    cube_std_f = cube_std.reshape(-1, side ** 3)
    choices, own_lat = _blend_consts(r, dev)
    nan = float("nan")

    if not interpolate:
        # own-lattice corner samples only (non-interp variant)
        own_batch = _batch_of(slot_to_batch,
                              indexer[torch.clamp(valid_blocks, min=0).to(torch.int64)])
        valid = block_ok & (own_batch >= 0)
        bsafe = torch.clamp(own_batch, min=0).to(torch.int64)
        sdf = cube_sdf_f[bsafe][:, own_lat]
        std = cube_std_f[bsafe][:, own_lat]
        v = valid[:, None].expand(B, nc)
        return (torch.where(v, sdf, nan).reshape(shape4),
                torch.where(v, std, nan).reshape(shape4),
                v.reshape(shape4))

    _, ny, nz = n_xyz
    num = torch.zeros(B, nc, device=dev)
    den = torch.zeros(B, nc, device=dev)
    wsum = torch.zeros(B, nc, device=dev)
    own_invalid = torch.zeros(B, nc, dtype=torch.bool, device=dev)
    for off_c, lat, w_c, is_own in choices:
        oob = torch.zeros(B, nc, dtype=torch.bool, device=dev)
        coords = []
        for a in range(3):
            ca = bpos[:, a][:, None] + off_c[a][None, :]                 # (B, nc)
            oob = oob | (ca < 0) | (ca >= n_xyz[a])
            coords.append(torch.clamp(ca, 0, n_xyz[a] - 1))
        cell = coords[0] * (ny * nz) + coords[1] * nz + coords[2]
        slot = indexer[cell]
        batch = _batch_of(slot_to_batch, slot)
        valid = (~oob) & (slot >= 0) & (batch >= 0) & block_ok[:, None]
        bsafe = torch.clamp(batch, min=0).to(torch.int64)
        s = cube_sdf_f[bsafe, lat[None, :]]
        t = cube_std_f[bsafe, lat[None, :]]
        w = w_c[None, :]
        wt = torch.where(valid, w * t, 0.0)
        num = num + torch.where(valid, s * wt, 0.0)
        den = den + wt
        wsum = wsum + torch.where(valid, w, 0.0)
        own_invalid = own_invalid | (is_own[None, :] & ~valid)

    corner_valid = (~own_invalid) & (den > 0)
    corner_sdf = torch.where(corner_valid, num / torch.clamp(den, min=1e-30), nan)
    corner_std = torch.where(corner_valid, den / torch.clamp(wsum, min=1e-30), nan)
    return (corner_sdf.reshape(shape4), corner_std.reshape(shape4),
            corner_valid.reshape(shape4))


@lru_cache(maxsize=32)
def _mc_consts(r: int, device: torch.device):
    """Subcell corner indices into the (r+1)^3 corner field (8, n), the
    subcell corner positions pa/pb of each edge and coordinate (12 x 3 x
    (n,) pairs, in grid units of the block), and the triangle table."""
    rp = r + 1
    sub = np.stack(np.meshgrid(*([np.arange(r)] * 3), indexing="ij"),
                   axis=-1).reshape(-1, 3)                                # (n, 3)
    corner_idx = np.stack([
        ((sub[:, 0] + dx) * rp * rp + (sub[:, 1] + dy) * rp + (sub[:, 2] + dz))
        for dx, dy, dz in CORNER_OFFSETS])                                # (8, n)
    edge_pos = []
    for e in range(12):
        a, b = (int(x) for x in EDGE_CORNERS[e])
        edge_pos.append([
            (torch.from_numpy((sub[:, c] + CORNER_OFFSETS[a][c]).astype(np.float32) / r)
             .to(device),
             torch.from_numpy((sub[:, c] + CORNER_OFFSETS[b][c]).astype(np.float32) / r)
             .to(device))
            for c in range(3)])
    return (torch.from_numpy(corner_idx.astype(np.int64)).to(device), edge_pos,
            torch.from_numpy(TRI_TABLE.astype(np.int64)).to(device))


def marching_cubes_sparse_plain(indexer: torch.Tensor, slot_to_batch: torch.Tensor,
                                valid_blocks: torch.Tensor, cube_sdf: torch.Tensor,
                                cube_std: torch.Tensor, n_xyz: Tuple[int, int, int],
                                r: int, max_triangles: int, max_std: float = 2000.0,
                                interpolate: bool = True,
                                out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                                ) -> McResult:
    """Plain PyTorch version of :func:`marching_cubes_sparse`."""
    dev = cube_sdf.device
    _, ny, nz = n_xyz
    B = valid_blocks.shape[0]
    rp = r + 1
    n = r ** 3                                       # subcells per block
    c_sdf, c_std, c_ok = corner_field(indexer, slot_to_batch, valid_blocks,
                                      cube_sdf, cube_std, n_xyz, r, interpolate)
    cs = c_sdf.reshape(B, rp ** 3)
    ct = c_std.reshape(B, rp ** 3)
    cv = c_ok.reshape(B, rp ** 3)
    corner_idx, edge_pos_c, tri_table = _mc_consts(r, dev)

    v_sdf = [cs[:, corner_idx[i]] for i in range(8)]                  # 8 x (B, n)
    v_std = [ct[:, corner_idx[i]] for i in range(8)]
    v_ok = [cv[:, corner_idx[i]] for i in range(8)]

    cube_ok = v_ok[0]
    for i in range(1, 8):
        cube_ok = cube_ok & v_ok[i]
    cube_type = sum((v_sdf[i] < 0).to(torch.int64) << i for i in range(8))
    cube_type = torch.where(cube_ok, cube_type, 0)                    # (B, n)

    # subcell corner positions in grid units: block_pos + (sub + corner)/r
    bpos = _block_pos(valid_blocks, n_xyz).to(torch.float32)         # (B, 3)

    # edge vertices: per edge, per coord a (B, n) position, and a (B, n) std
    edge_pos = []     # [e][c] -> (B, n)
    edge_std = []     # [e]    -> (B, n)
    for e in range(12):
        a, b = (int(x) for x in EDGE_CORNERS[e])
        va, vb_ = v_sdf[a], v_sdf[b]
        # sdf_interp: the later where wins
        w2 = -va / torch.where(torch.abs(vb_ - va) < 1e-30, 1e-30, vb_ - va)
        w2 = torch.where(torch.abs(va - vb_) < 1e-5, 0.0, w2)
        w2 = torch.where(torch.abs(vb_) < 1e-5, 1.0, w2)
        w2 = torch.where(torch.abs(va) < 1e-5, 0.0, w2)
        pos_c = []
        for c in range(3):
            pa, pb = edge_pos_c[e][c]
            pos_c.append(pa[None, :] * (1.0 - w2) + pb[None, :] * w2
                         + bpos[:, c][:, None])
        edge_pos.append(pos_c)
        edge_std.append(v_std[a] * (1.0 - w2) + v_std[b] * w2)

    epos = [torch.stack([edge_pos[e][c] for e in range(12)], dim=-1)   # (B, n, 12)
            for c in range(3)]
    estd = torch.stack(edge_std, dim=-1)                               # (B, n, 12)

    tri_edges = tri_table[cube_type]                                   # (B, n, 16)
    block_of_sub = valid_blocks[:, None].expand(B, n)

    # candidate triangles: 5 per subcell, rows (9, B*n) per slab
    rows, srows, masks = [], [], []
    for t in range(5):
        e = tri_edges[..., 3 * t:3 * t + 3]                            # (B, n, 3)
        exists = (e[..., 0] >= 0) & cube_ok
        esafe = torch.clamp(e, min=0)
        vstd_t, vrow_t = [], []
        for k in range(3):
            ek = esafe[..., k:k + 1]                                   # (B, n, 1)
            vstd_t.append(torch.gather(estd, -1, ek)[..., 0])
            for c in range(3):
                vrow_t.append(torch.gather(epos[c], -1, ek)[..., 0])  # row k*3+c
        exists = exists & (vstd_t[0] <= max_std) & (vstd_t[1] <= max_std) \
            & (vstd_t[2] <= max_std)
        rows.append(torch.stack([v.reshape(-1) for v in vrow_t]))      # (9, B*n)
        srows.append(torch.stack([v.reshape(-1) for v in vstd_t]))     # (3, B*n)
        masks.append(exists.reshape(-1))

    all_tris = torch.cat(rows, dim=1)                                  # (9, 5*B*n)
    all_stds = torch.cat(srows, dim=1)                                 # (3, 5*B*n)
    all_mask = torch.cat(masks)                                        # (5*B*n,)
    all_block = block_of_sub.reshape(-1).repeat(5)

    # ordered compaction: every dropped or overflowing candidate lands in the
    # extra row max_triangles, which is sliced off, so the write order of
    # duplicate indices does not matter
    order = torch.cumsum(all_mask.to(torch.int64), 0) - 1
    out_idx = torch.where(all_mask & (order < max_triangles), order, max_triangles)
    packed = torch.zeros(max_triangles + 1, ROW, device=dev)
    packed.view(torch.int32)[:, 12] = -1
    packed[out_idx] = torch.cat([all_tris, all_stds,
                                 all_block.to(torch.int32).view(torch.float32)[None]]).T
    if out is None:
        return _result(packed[:-1], all_mask.sum())
    out[0].copy_(packed[:-1])
    out[1].copy_(all_mask.sum())
    return _result(*out)


_lib = None


def _load():
    """csrc/marching_cubes.cu's library, its entry points typed once per
    process."""
    global _lib
    if _lib is None:
        lib = _build.load("marching_cubes")
        lib.mc_workspace_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.mc_workspace_bytes.restype = ctypes.c_longlong
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mc_sparse_launch.argtypes = [p, p, ll, p, i, p, p, ll, ll, ll, i, i, p,
                                         ctypes.c_float, i, p, p, p, p]
        lib.mc_sparse_launch.restype = ctypes.c_int
        f = ctypes.c_float
        lib.mc_splice_launch.argtypes = [p, p, i, i, ll, f, f, f, f, f, f, f, p, ll, p, p, p, p,
                                         p]
        lib.mc_splice_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


@lru_cache(maxsize=8)
def _tri_table(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(TRI_TABLE.astype(np.int8)).to(device)


def _check(what: str, dev, tensors, where: str = "") -> None:
    """What a kernel takes: each (name, tensor, dtype, shape ok) a
    contiguous ``dtype`` tensor on ``dev`` of an accepted shape, else
    ValueError."""
    for name, t, dtype, ok in tensors:
        if t.device != dev or t.dtype != dtype or not ok or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} tensor on {dev}"
                             f"{where}, got {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"contiguous {t.is_contiguous()}")


def _check_inputs(indexer, slot_to_batch, valid_blocks, cube_sdf, cube_std, n_xyz, r,
                  max_triangles) -> None:
    """What the kernels take: contiguous tensors on one card, int32 indexer
    and block list, int64 slot_to_batch, f32 (rows, 2r, 2r, 2r) lattices."""
    n_cells = int(np.prod(n_xyz))
    side = 2 * r
    _check("marching_cubes_sparse", cube_sdf.device, (
        ("indexer", indexer, torch.int32, indexer.shape == (n_cells,)),
        ("slot_to_batch", slot_to_batch, torch.int64,
         slot_to_batch.dim() == 1 and slot_to_batch.numel() >= 1),
        ("valid_blocks", valid_blocks, torch.int32, valid_blocks.dim() == 1),
        ("cube_sdf", cube_sdf, torch.float32,
         cube_sdf.dim() == 4 and cube_sdf.shape[1:] == (side,) * 3),
        ("cube_std", cube_std, torch.float32, cube_std.shape == cube_sdf.shape)),
        f" (n_xyz {tuple(n_xyz)}, r {r})")
    if r < 1 or not 0 <= ROW * max_triangles < 2 ** 31 \
            or SLABS * valid_blocks.shape[0] * r ** 3 >= 2 ** 31:
        raise ValueError(f"marching_cubes_sparse: needs r >= 1, 0 <= 13 * max_triangles "
                         f"< 2^31 and 5 * blocks * r^3 < 2^31 (32-bit indices), got r {r}, "
                         f"max_triangles {max_triangles}, {valid_blocks.shape[0]} blocks")


def marching_cubes_sparse(indexer: torch.Tensor, slot_to_batch: torch.Tensor,
                          valid_blocks: torch.Tensor, cube_sdf: torch.Tensor,
                          cube_std: torch.Tensor, n_xyz: Tuple[int, int, int],
                          r: int, max_triangles: int, max_std: float = 2000.0,
                          interpolate: bool = True,
                          out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> McResult:
    """Emit triangles for all active blocks.  ``cube_sdf`` must already
    carry the sign flip (the mesher negates the decoder output).  CUDA
    tensors launch the kernels of ``csrc/marching_cubes.cu`` on the current
    stream (or raise); CPU tensors run :func:`marching_cubes_sparse_plain`.
    ``out``: the (max_triangles, 13) f32 buffer and the () int64 count to
    write, contiguous, in place of new ones."""
    if not cube_sdf.is_cuda:
        return marching_cubes_sparse_plain(indexer, slot_to_batch, valid_blocks, cube_sdf,
                                           cube_std, n_xyz, r, max_triangles, max_std,
                                           interpolate, out)
    _check_inputs(indexer, slot_to_batch, valid_blocks, cube_sdf, cube_std, n_xyz, r,
                  max_triangles)
    dev = cube_sdf.device
    lib = _load()
    n_blocks = valid_blocks.shape[0]
    work = torch.empty(lib.mc_workspace_bytes(n_blocks, r), dtype=torch.uint8, device=dev)
    if out is None:
        packed = torch.empty(max_triangles, ROW, device=dev)
        count = torch.empty((), dtype=torch.int64, device=dev)
    else:
        packed, count = out
        _check("marching_cubes_sparse", dev, (
            ("out", packed, torch.float32, packed.shape == (max_triangles, ROW)),
            ("out", count, torch.int64, count.shape == ())))
    nx, ny, nz = (int(v) for v in n_xyz)
    err = _build.launch_on(
        dev.index, lib.mc_sparse_launch, indexer.data_ptr(), slot_to_batch.data_ptr(),
        slot_to_batch.numel(), valid_blocks.data_ptr(), n_blocks, cube_sdf.data_ptr(),
        cube_std.data_ptr(), nx, ny, nz, int(r), int(bool(interpolate)),
        _tri_table(dev).data_ptr(), float(max_std), int(max_triangles), work.data_ptr(),
        packed.data_ptr(), count.data_ptr())
    _build.check(err, "marching_cubes_sparse")
    for name in ("mc_classify", "mc_scan", "mc_emit"):
        _build.count_launch(name)
    return _result(packed, count)


def _f32(v) -> float:
    """``v`` rounded to f32, as numpy rounds a Python float or an int64
    operand of an f32 array's arithmetic, held exactly as a float."""
    return float(np.float32(v))


def mc_splice_plain(packed: torch.Tensor, counts: torch.Tensor, table: torch.Tensor,
                    origin, voxel_size: float, world_origin, max_triangles: int) -> Spliced:
    """Plain PyTorch version of :func:`mc_splice`: the host's numpy splice
    (concatenate each chunk's kept rows, truncate, ``(tris + origin) *
    voxel_size + world_origin``, ``table[blocks]``) as tensor ops, each
    rounded as numpy rounds it.  Its outputs hold exactly the kept rows."""
    dev = packed.device
    n_chunks, budget = packed.shape[:2]
    kept = torch.clamp(counts, max=budget)
    live = torch.arange(budget, device=dev)[None, :] < kept[:, None]
    rows = packed[live][:max_triangles]                         # chunk order
    f32 = torch.float32
    o = torch.tensor([_f32(v) for v in origin], dtype=f32, device=dev)
    w = torch.tensor([_f32(v) for v in world_origin], dtype=f32, device=dev)
    tris = (rows[:, :9].reshape(-1, 3, 3) + o) * torch.tensor(_f32(voxel_size), dtype=f32,
                                                                device=dev) + w
    blocks = rows.view(torch.int32)[:, 12].to(torch.int64)
    inside = (blocks >= 0) & (blocks < table.shape[0])
    slots = torch.where(inside, table[torch.clamp(blocks, 0, table.shape[0] - 1)], -1)
    totals = torch.stack([counts.sum(), torch.tensor(rows.shape[0], device=dev)])
    return Spliced(tris, rows[:, 9:12].contiguous(), slots, totals)


def mc_splice(packed: torch.Tensor, counts: torch.Tensor, table: torch.Tensor, origin,
              voxel_size: float, world_origin, max_triangles: int) -> Spliced:
    """Splice an extract's marching-cubes chunks: ``packed`` (K, budget, 13)
    f32 holds chunk k's rows (:class:`McResult`'s layout) and ``counts``
    (K,) int64 its survivors; the first ``min(count_k, budget)`` rows of
    each chunk, in chunk order and truncated at ``max_triangles``, become
    world-space vertices ``(v + origin) * voxel_size + world_origin``
    (``origin`` (3,) the grid's origin in cells, ``world_origin`` (3,)
    metres), their stds and their slot ``table[block]`` (``table`` int64, a
    grid cell's slot; -1 outside it).  CUDA tensors launch the splice kernel
    of ``csrc/marching_cubes.cu`` once on the current stream (or raise); CPU
    tensors run :func:`mc_splice_plain`."""
    if not packed.is_cuda:
        return mc_splice_plain(packed, counts, table, origin, voxel_size, world_origin,
                               max_triangles)
    dev = packed.device
    shaped = packed.dim() == 3 and packed.shape[0] >= 1 and packed.shape[2] == ROW
    n_chunks, budget = packed.shape[:2] if shaped else (0, 0)
    _check("mc_splice", dev, (
        ("packed", packed, torch.float32, shaped),
        ("counts", counts, torch.int64, counts.shape == (n_chunks,)),
        ("table", table, torch.int64, table.dim() == 1 and table.numel() >= 1)),
        f" (packed (chunks >= 1, budget, {ROW}), counts (chunks,), table 1-D, not empty)")
    if not 0 <= ROW * budget < 2 ** 31 or max_triangles < 0:
        raise ValueError(f"mc_splice: needs 13 * budget < 2^31 and max_triangles >= 0, got "
                         f"budget {budget}, max_triangles {max_triangles}")
    cap = min(int(max_triangles), n_chunks * budget)
    tris = torch.empty(cap, 3, 3, device=dev)
    stds = torch.empty(cap, 3, device=dev)
    slots = torch.empty(cap, dtype=torch.int64, device=dev)
    totals = torch.empty(2, dtype=torch.int64, device=dev)
    err = _build.launch_on(
        dev.index, _load().mc_splice_launch, packed.data_ptr(), counts.data_ptr(), n_chunks,
        budget, cap, *(_f32(v) for v in origin), _f32(voxel_size),
        *(_f32(v) for v in world_origin), table.data_ptr(), table.shape[0], tris.data_ptr(),
        stds.data_ptr(), slots.data_ptr(), totals.data_ptr())
    _build.check(err, "mc_splice")
    _build.count_launch("mc_splice")
    return Spliced(tris, stds, slots, totals)
