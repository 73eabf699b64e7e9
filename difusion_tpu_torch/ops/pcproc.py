"""Point-cloud ops on tensors (counterpart of difusion_tpu/ops/pcproc.py):
fixed-radius neighbours on a sorted spatial grid, radius-outlier removal,
PCA normals, the voxel box filter and stable compaction.

Neighbour search (the reference's pcproc.cu + cuda_kdtree.cu): a uniform
grid of cell size = radius, its points sorted by a 32-bit hash of their cell,
answers a radius query with 27 runs of at most ``cell_cap`` candidates found
by ``searchsorted``; each candidate's exact cell is checked, so a hash
collision inside a run costs a slot, never a wrong neighbour.  Exact up to
that cap, as the reference's FLANN search is under its ``checks`` budget.
All of it is plain PyTorch on the caller's device.  The hash is the JAX
package's uint32 arithmetic in int64, masked to 32 bits; the sorts are
stable, as ``jnp.argsort`` is, so the same candidates fill the cap.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..device import const
from .imgproc import recip, sym3eig_smallest

_HASH_PRIMES = (73856093, 19349663, 83492791)
_KNUTH = 2654435761
_SENTINEL = 0xFFFFFFFF
_NEIGHBOR_CELLS = tuple((dx, dy, dz) for dx in (-1, 0, 1)
                        for dy in (-1, 0, 1) for dz in (-1, 0, 1))   # (27, 3)


class NeighborGrid(NamedTuple):
    """Sorted spatial grid over a fixed-size point set."""
    points: torch.Tensor       # (N, 3) f32
    valid: torch.Tensor        # (N,) bool
    cell: torch.Tensor         # (N, 3) int32 cell of each point
    order: torch.Tensor        # (N,) int64 point index sorted by cell hash
    sorted_hash: torch.Tensor  # (N,) int64 holding the uint32 hash, sorted
    cell_size: float


def _hash_cells(cell: torch.Tensor) -> torch.Tensor:
    """uint32 hash of integer cells (..., 3) as int64 in [0, 2^32): each
    coordinate wraps to uint32 (two's complement, as ``astype(uint32)``),
    times its prime mod 2^32, XORed."""
    c = cell.to(torch.int64) & _SENTINEL
    return (((c[..., 0] * _HASH_PRIMES[0]) & _SENTINEL)
            ^ ((c[..., 1] * _HASH_PRIMES[1]) & _SENTINEL)
            ^ ((c[..., 2] * _HASH_PRIMES[2]) & _SENTINEL))


def _cells(points: torch.Tensor, cell_size: float) -> torch.Tensor:
    """Integer cells of the points: ``floor(points / cell_size)``, a true
    division on every device, as the JAX function computes it (PyTorch on
    CUDA multiplies by the reciprocal of a Python-number divisor, which
    puts a point on a cell boundary into another cell than the CPU does)."""
    size = torch.full((), cell_size, dtype=points.dtype, device=points.device)
    return torch.floor(points / size).to(torch.int32)


def build_grid(points: torch.Tensor, valid: torch.Tensor, cell_size: float) -> NeighborGrid:
    cell = _cells(points, cell_size)
    # invalid points take the largest hash, sort last and fail the
    # candidates' validity check
    h = torch.where(valid, _hash_cells(cell), torch.full((), _SENTINEL,
                                                         device=points.device))
    sorted_hash, order = torch.sort(h, stable=True)
    return NeighborGrid(points=points, valid=valid, cell=cell, order=order,
                        sorted_hash=sorted_hash, cell_size=float(cell_size))


def radius_neighbors(grid: NeighborGrid, queries: torch.Tensor,
                     q_valid: torch.Tensor, radius: float,
                     cell_cap: int = 16, exclude_self_index: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All grid points within ``radius`` of each query, at most ``cell_cap``
    a cell of the 27 around it.  Returns (idx (Q, 27*cell_cap) int32 into the
    grid's points, ok (Q, 27*cell_cap) bool).  ``exclude_self_index`` drops
    the candidate whose index is the query's own position (self-queries;
    the reference's estimate_normal skips nn_i == 0, pcproc.cu:115)."""
    dev = queries.device
    nq, n = queries.shape[0], grid.points.shape[0]
    nb_cell = (_cells(queries, grid.cell_size)[:, None, :]
               + const(_NEIGHBOR_CELLS, dev, torch.int32)[None])       # (Q, 27, 3)
    nb_hash = _hash_cells(nb_cell)                                      # (Q, 27)
    start = torch.searchsorted(grid.sorted_hash, nb_hash.reshape(-1)).reshape(nb_hash.shape)
    pos = start[..., None] + torch.arange(cell_cap, device=dev)        # (Q, 27, C)
    slot = torch.clamp(pos, max=n - 1)
    cand = grid.order[slot]
    # a run that ends the sorted array stops there: the JAX package clamps
    # the slot and counts the last point once for every slot past the end
    ok = (grid.sorted_hash[slot] == nb_hash[..., None]) & (pos < n)
    del pos, slot
    # the exact cell: a colliding cell's points in the run are rejected
    ok &= torch.all(grid.cell[cand] == nb_cell[..., None, :], dim=-1)
    ok &= grid.valid[cand] & q_valid[:, None, None]
    diff = grid.points[cand] - queries[:, None, None, :]
    # summed x, y, z in this order on every device (a reduction kernel may
    # pair them otherwise), so a neighbour on the sphere is in or out alike
    d2 = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
    del diff
    ok &= d2 <= radius * radius
    del d2
    if exclude_self_index:
        ok &= cand != torch.arange(nq, device=dev)[:, None, None]
    return cand.to(torch.int32).reshape(nq, -1), ok.reshape(nq, -1)


def remove_radius_outlier(points: torch.Tensor, valid: torch.Tensor,
                          nb_points: int = 16, radius: float = 0.05,
                          cell_cap: int = 16) -> torch.Tensor:
    """Keep the points with >= nb_points neighbours (self included) within
    radius (the reference's remove_radius_outlier, pcproc.cu:160-187: the
    (nb_points-1)-th kNN distance below radius)."""
    grid = build_grid(points, valid, radius)
    _, ok = radius_neighbors(grid, points, valid, radius, cell_cap)
    return valid & (ok.sum(dim=-1) >= nb_points)


def estimate_normals(points: torch.Tensor, valid: torch.Tensor,
                     max_nn: int = 16, radius: float = 0.1,
                     cam_xyz=(0.0, 0.0, 0.0), cell_cap: int = 16
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PCA normals of the radius neighbours (self excluded), flipped to face
    ``cam_xyz`` (the reference's estimate_normals, pcproc.cu:107-158,
    189-210).  Every neighbour within the cap counts: ``max_nn`` only bounded
    the reference's kNN buffer.  A normal needs >= 5 neighbours.  Returns
    (normal (N, 3), ok (N,))."""
    grid = build_grid(points, valid, radius)
    idx, ok = radius_neighbors(grid, points, valid, radius, cell_cap,
                               exclude_self_index=True)
    w = ok.to(points.dtype)                                      # (N, K)
    cnt = w.sum(dim=-1)
    nb = points[idx.long()]                                      # (N, K, 3)
    mean = torch.sum(nb * w[..., None], dim=1) / torch.clamp(cnt, min=1.0)[:, None]
    centred = nb - mean[:, None, :]
    del nb
    cov = torch.einsum("nka,nkb->nab", centred * w[..., None], centred)
    del centred
    normal, _ = sym3eig_smallest(cov)
    to_cam = points - torch.tensor(cam_xyz, dtype=points.dtype, device=points.device)
    flip = torch.sum(normal * to_cam, dim=-1) > 0.0
    return torch.where(flip[:, None], -normal, normal), valid & (cnt >= 5.0)


def point_box_filter(points: torch.Tensor, normals: torch.Tensor,
                     valid: torch.Tensor, voxel_size: float, out_budget: int,
                     aabb: Optional[tuple] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Voxel-mean downsample: average points/normals per occupied voxel and
    keep the first ``out_budget`` voxels in key order.

    ``aabb`` = ((x0, y0, z0), (x1, y1, z1)) bounds the valid points (the
    camera frustum at the depth cut).  Where its cell grid fits an int32,
    cells pack into one exact linear key (valid points outside it are
    dropped), scrambled by the bijective Knuth multiplicative hash mod 2^32
    before the sort, so when the occupied cells exceed ``out_budget`` the
    kept subset is a spatially unbiased sample (a raw linear key keeps an
    x-sorted slab: +60% ATE on the reference's 120-frame noise study).
    Otherwise the points sort by cell hash and then by cell (four stable
    sorts, ``jnp.lexsort``'s order), so colliding cells stay apart.  Returns
    (points (B, 3), normals (B, 3), ok (B,))."""
    n = points.shape[0]
    dev, dt = points.device, points.dtype
    ref = torch.floor(points * recip(voxel_size)).to(torch.int64)
    dims = None
    if aabb is not None:
        lo = [int(math.floor(c / voxel_size)) - 1 for c in aabb[0]]
        hi = [int(math.floor(c / voxel_size)) + 1 for c in aabb[1]]
        dims = [h - l + 1 for l, h in zip(lo, hi)]
        if dims[0] * dims[1] * dims[2] >= 2 ** 31:
            dims = None
    if dims is not None:
        ix = ref - const(tuple(lo), dev, torch.int64)
        inb = valid & torch.all((ix >= 0) & (ix < const(tuple(dims), dev, torch.int64)),
                                dim=1)
        key = (ix[:, 0] * dims[1] + ix[:, 1]) * dims[2] + ix[:, 2]
        key = (key * _KNUTH) & _SENTINEL          # uint32 wrap-around multiply
        key = torch.where(inb, key, torch.full_like(key, _SENTINEL))
        key_s, order = torch.sort(key, stable=True)
        same = key_s == torch.roll(key_s, 1)
        v_s = (key_s != _SENTINEL).to(dt)
    else:
        h = torch.where(valid, _hash_cells(ref), torch.full((), _SENTINEL, device=dev))
        order = torch.arange(n, device=dev)
        for key in (ref[:, 2], ref[:, 1], ref[:, 0], h):     # least significant first
            order = order[torch.sort(key[order], stable=True).indices]
        h_s, ref_s = h[order], ref[order]
        same = (h_s == torch.roll(h_s, 1)) & torch.all(
            ref_s == torch.roll(ref_s, 1, dims=0), dim=1)
        v_s = valid[order].to(dt)
    seg_start = ~same
    seg_start[:1].fill_(True)     # (an indexed assignment of a host scalar is a copy)

    # segment sums as differences of one prefix sum at the segment starts;
    # the payload is rebased (points to their cell centre, normals to the
    # frame mean) so the f32 prefix stays small
    vsz = voxel_size
    keep2 = valid[:, None]
    zero = torch.zeros((), dtype=dt, device=dev)
    p_rel = torch.where(keep2, points - ref.to(dt) * vsz - 0.5 * vsz, zero)
    nrm_safe = torch.where(keep2, normals, zero)
    n_valid = torch.clamp(valid.to(dt).sum(), min=1.0)
    n_base = nrm_safe.sum(dim=0) / n_valid
    payload = torch.cat([p_rel, nrm_safe - torch.where(keep2, n_base[None], zero),
                         torch.ones((n, 1), dtype=dt, device=dev)], dim=1)
    pay_s = payload[order] * v_s[:, None]
    # scan along the contiguous dim: PyTorch's outer-dim scan kernel took
    # ~10 ms per frame for this (76800, 7) payload on an H100
    csum = torch.cat([torch.zeros((1, 7), dtype=dt, device=dev),
                      torch.cumsum(pay_s.T.contiguous(), dim=1).T])
    pos = torch.where(seg_start, torch.arange(n, device=dev),
                      torch.full((n,), n, device=dev))
    if out_budget + 1 > n:
        pos = torch.cat([pos, torch.full((out_budget + 1 - n,), n, device=dev)])
    start = torch.sort(pos).values[:out_budget + 1]
    sums = csum[start[1:]] - csum[start[:-1]]
    cnts = sums[:, 6]
    inv = 1.0 / torch.clamp(cnts, min=1.0)
    ok = cnts > 0.5
    first_row = ref[order[torch.clamp(start[:-1], max=n - 1)]]
    corner = first_row.to(dt) * vsz + 0.5 * vsz
    mean_p = torch.where(ok[:, None], sums[:, 0:3] * inv[:, None] + corner, zero)
    mean_n = torch.where(ok[:, None], sums[:, 3:6] * inv[:, None] + n_base[None],
                         zero)
    return mean_p, mean_n, ok


def compact(valid: torch.Tensor, budget: int, *arrays: torch.Tensor):
    """Move the valid rows to the front (stable) and keep ``budget`` of them.
    Returns (mask (budget,), *arrays[:budget])."""
    order = torch.sort((~valid).to(torch.uint8), stable=True).indices
    return (valid[order][:budget],) + tuple(a[order][:budget] for a in arrays)
