"""Voxel box filter of a point cloud (counterpart of
difusion_tpu/ops/pcproc.py:144-264, the bounded single-key path).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..device import const
from .imgproc import recip

_KNUTH = 2654435761
_SENTINEL = 0xFFFFFFFF


def point_box_filter(points: torch.Tensor, normals: torch.Tensor,
                     valid: torch.Tensor, voxel_size: float, out_budget: int,
                     aabb: tuple) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Voxel-mean downsample: average points/normals per occupied voxel and
    keep the first ``out_budget`` voxels in key order.

    ``aabb`` = ((x0, y0, z0), (x1, y1, z1)) bounds the valid points (the
    camera frustum at the depth cut); cells pack into one exact linear key,
    valid points outside it are dropped.  The key is scrambled by the
    bijective Knuth multiplicative hash mod 2^32 before the sort, so when the
    occupied cells exceed ``out_budget`` the kept subset is a spatially
    unbiased sample (a raw linear key keeps an x-sorted slab: +60% ATE on the
    reference's 120-frame noise study).  Returns (points (B, 3), normals
    (B, 3), ok (B,))."""
    n = points.shape[0]
    dev, dt = points.device, points.dtype
    ref = torch.floor(points * recip(voxel_size)).to(torch.int64)
    lo = [int(math.floor(c / voxel_size)) - 1 for c in aabb[0]]
    hi = [int(math.floor(c / voxel_size)) + 1 for c in aabb[1]]
    dims = [h - l + 1 for l, h in zip(lo, hi)]
    if dims[0] * dims[1] * dims[2] >= 2 ** 31:
        raise NotImplementedError("point_box_filter: the aabb's cell grid "
                                  "exceeds one int32 key")
    ix = ref - const(tuple(lo), dev, torch.int64)
    inb = valid & torch.all((ix >= 0) & (ix < const(tuple(dims), dev, torch.int64)),
                            dim=1)
    key = (ix[:, 0] * dims[1] + ix[:, 1]) * dims[2] + ix[:, 2]
    key = (key * _KNUTH) & _SENTINEL          # uint32 wrap-around multiply
    key = torch.where(inb, key, torch.full_like(key, _SENTINEL))
    key_s, order = torch.sort(key, stable=True)
    same = key_s == torch.roll(key_s, 1)
    v_s = (key_s != _SENTINEL).to(dt)
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
