"""A full mesh extract, plainly: DI-Fusion's meshing of a latent-voxel map.

Every cell observed more than ``ignore_count_th`` times is a block.  The
decoder is evaluated on each block's lattice of (2r)^3 sites, spaced 1/r
voxel and reaching r/2 sites into each neighbour.  The field at a corner of
the map's fine grid (r corners a voxel) blends the lattices of the blocks
whose lattices hold it, each weighted by a tent of width one voxel about the
block's centre along every axis times the std it predicts there:
``sdf = sum w std sdf / sum w std``, ``std = sum w std / sum w``.  Marching
cubes (Lorensen and Cline's 256 cases) runs over every fine cube of every
block on the negated sdf, a vertex on an edge where the line through its
two corner values crosses 0 (snapped to a corner whose value, or to the
near end where the two values, lie within 1e-5), its std interpolated the
same way; a triangle with a vertex std above ``max_std`` is dropped.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .mc_tables import CORNER_OFFSETS, EDGE_CORNERS, TRI_TABLE


def _block_lattices(vmap, prior, blocks: torch.Tensor, r: int, chunk: int = 1 << 20):
    """sdf, std (n, 2r, 2r, 2r) of each block's lattice: site l along an
    axis at (l - r//2) / r - 1/2 voxels from the block's centre."""
    dev = blocks.device
    side = 2 * r
    ar = (torch.arange(side, device=dev, dtype=torch.float32) - (r // 2)) / r - 0.5
    g = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1).reshape(-1, 3)
    per = side ** 3
    n = blocks.shape[0]
    sdf = torch.empty(n * per, device=dev)
    std = torch.empty(n * per, device=dev)
    step = max(chunk // per, 1)
    for b0 in range(0, n, step):
        lat = vmap.latent[blocks[b0:b0 + step]]
        c = lat.shape[0]
        s, t = prior.decode(lat[:, None, :].expand(c, per, -1).reshape(-1, lat.shape[1]),
                            g[None].expand(c, per, 3).reshape(-1, 3))
        sdf[b0 * per:(b0 + c) * per] = s
        std[b0 * per:(b0 + c) * per] = t
    return sdf.reshape(n, side, side, side), std.reshape(n, side, side, side)


def extract(vmap, prior, r: int, max_std: float, only=None, block_chunk: int = 512
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Triangles (T, 3, 3) in world metres, their vertex stds (T, 3) and the
    cell of the block each was meshed for (T, 3).
    ``only``: a bool per grid cell; the extract then meshes, and blends
    over, those of the blocks alone (an incremental extract's set)."""
    dev = vmap.device
    live = vmap.alloc & (vmap.count > vmap.ignore)
    if only is not None:
        live = live & only
    blocks = torch.nonzero(live)[:, 0]
    n = blocks.shape[0]
    if n == 0:
        return (torch.zeros(0, 3, 3, device=dev), torch.zeros(0, 3, device=dev),
                torch.zeros(0, 3, dtype=torch.int64, device=dev))
    sdf, std = _block_lattices(vmap, prior, blocks, r)
    sdf = -sdf                                     # marching cubes' sign
    block_of = torch.full((vmap.alloc.shape[0],), -1, dtype=torch.int64, device=dev)
    block_of[blocks] = torch.arange(n, device=dev)
    cells = vmap.cells()[blocks]                   # (n, 3) integer cells
    half = r / 2.0
    rp = r + 1
    cr = torch.arange(rp, device=dev)
    corner = torch.stack(torch.meshgrid(cr, cr, cr, indexing="ij"), -1).reshape(-1, 3)
    cube = torch.stack(torch.meshgrid(*(torch.arange(r, device=dev),) * 3, indexing="ij"),
                       -1).reshape(-1, 3)
    coff = torch.as_tensor(CORNER_OFFSETS, device=dev).long()
    ecorn = torch.as_tensor(EDGE_CORNERS, device=dev).long()
    table = torch.as_tensor(TRI_TABLE, device=dev).long()
    origin = torch.tensor(vmap.origin, device=dev)
    tris, stds, owner = [], [], []
    for b0 in range(0, n, block_chunk):
        bc = cells[b0:b0 + block_chunk]
        m = bc.shape[0]
        G = bc[:, None, :] * r + corner[None]                  # (m, rp^3, 3) fine corners
        c0 = torch.floor((G - half) / r).long()                # the lower candidate block
        num = torch.zeros(m, rp ** 3, device=dev)
        den = torch.zeros_like(num)
        wsum = torch.zeros_like(num)
        for ix in range(2):
            for iy in range(2):
                for iz in range(2):
                    C = c0 + torch.tensor([ix, iy, iz], device=dev)
                    w = torch.prod(1.0 - (G - C * r - half).abs() / r, dim=-1).float()
                    idx, inside = vmap._index(C)
                    b = torch.where(inside, block_of[idx], -1)
                    ok = b >= 0
                    lidx = G - C * r + r // 2
                    site = ((lidx[..., 0] * 2 * r + lidx[..., 1]) * 2 * r + lidx[..., 2])
                    bs = b.clamp(min=0)
                    s = sdf.reshape(n, -1)[bs, site.clamp(0, (2 * r) ** 3 - 1)]
                    t = std.reshape(n, -1)[bs, site.clamp(0, (2 * r) ** 3 - 1)]
                    wt = torch.where(ok, w * t, 0.0)
                    num = num + torch.where(ok, wt * s, 0.0)
                    den = den + wt
                    wsum = wsum + torch.where(ok, w, 0.0)
        cs = (num / den).reshape(m, rp, rp, rp)
        ct = (den / wsum).reshape(m, rp, rp, rp)
        # the 8 corners of every fine cube
        ci = cube[None, :, None, :] + coff[None, None]          # (1, r^3, 8, 3)
        vs = cs[:, ci[0, :, :, 0], ci[0, :, :, 1], ci[0, :, :, 2]]   # (m, r^3, 8)
        vt = ct[:, ci[0, :, :, 0], ci[0, :, :, 1], ci[0, :, :, 2]]
        case = ((vs < 0).long() << torch.arange(8, device=dev)).sum(-1)
        va, vb = vs[..., ecorn[:, 0]], vs[..., ecorn[:, 1]]     # (m, r^3, 12)
        ta, tb = vt[..., ecorn[:, 0]], vt[..., ecorn[:, 1]]
        diff = vb - va
        w2 = -va / torch.where(diff.abs() < 1e-30, torch.full_like(diff, 1e-30), diff)
        w2 = torch.where((va - vb).abs() < 1e-5, 0.0, w2)
        w2 = torch.where(vb.abs() < 1e-5, 1.0, w2)
        w2 = torch.where(va.abs() < 1e-5, 0.0, w2)
        pa = (cube[None, :, None, :] + coff[ecorn[:, 0]][None, None]).float()
        pb = (cube[None, :, None, :] + coff[ecorn[:, 1]][None, None]).float()
        pos = pa * (1 - w2[..., None]) + pb * w2[..., None]    # (m, r^3, 12, 3) fine units
        pos = (bc[:, None, None, :].float() * r + pos) / r     # voxel units
        est = ta * (1 - w2) + tb * w2
        te = table[case]                                        # (m, r^3, 16)
        for k in range(5):
            e = te[..., 3 * k:3 * k + 3]
            has = e[..., 0] >= 0
            es = e.clamp(min=0)
            p = torch.gather(pos, 2, es[..., None].expand(*es.shape, 3))   # (m, r^3, 3, 3)
            s = torch.gather(est, 2, es)
            keep = has & (s <= max_std).all(-1)
            tris.append(p[keep])
            stds.append(s[keep])
            owner.append(bc[:, None, :].expand(m, r ** 3, 3)[keep])
    t = torch.cat(tris) * vmap.vs + origin
    return t, torch.cat(stds), torch.cat(owner)


def edge_keys(v: torch.Tensor, origin, vs: float, r: int, tol: float = 1e-3):
    """Vertices (n, 3) in world metres -> (keys (n, 4) int64, position along
    the edge (n,)): the fine-grid edge a vertex lies on (its lower corner and
    axis 0-2), or 3 for a vertex on a corner."""
    g = (v.double() - torch.tensor(origin, dtype=torch.float64, device=v.device)) / vs * r
    near = torch.round(g)
    off = (g - near).abs() > tol
    axis = torch.where(off.any(-1), off.double().argmax(-1), torch.full_like(off[:, 0], 3, dtype=torch.int64))
    low = torch.where(off, torch.floor(g), near).long()
    frac = torch.where(axis < 3, (g - torch.floor(g)).gather(1, axis.clamp(max=2)[:, None])[:, 0],
                       torch.zeros_like(g[:, 0]))
    return torch.cat([low, axis[:, None]], 1), frac


def compare(prog: torch.Tensor, ref: torch.Tensor, origin, vs: float, r: int
            ) -> Tuple[float, float, int, int]:
    """(widest gap in metres between a vertex of the program's mesh and the
    reference's on the same fine edge, the share of edges with a vertex on
    one side only, program vertices, reference vertices)."""
    def unique(v):
        k, f = edge_keys(v.reshape(-1, 3), origin, vs, r)
        u, inv = torch.unique(k, dim=0, return_inverse=True)
        pos = torch.zeros(u.shape[0], dtype=torch.float64, device=v.device).scatter_(0, inv, f)
        return u, pos
    ku, fu = unique(prog)
    kr, fr = unique(ref)
    allk, inv = torch.unique(torch.cat([ku, kr]), dim=0, return_inverse=True)
    n_all = allk.shape[0]
    side = torch.zeros(n_all, dtype=torch.int64, device=prog.device)
    side.index_add_(0, inv[:ku.shape[0]], torch.ones_like(inv[:ku.shape[0]]))
    side.index_add_(0, inv[ku.shape[0]:], 2 * torch.ones_like(inv[ku.shape[0]:]))
    pu = torch.full((n_all,), float("nan"), dtype=torch.float64, device=prog.device)
    pr = torch.full_like(pu, float("nan"))
    pu[inv[:ku.shape[0]]] = fu
    pr[inv[ku.shape[0]:]] = fr
    both = side == 3
    gap = float(((pu - pr).abs()[both]).max()) * vs / r if bool(both.any()) else float("inf")
    lonely = float((~both).sum()) / max(n_all, 1)
    return gap, lonely, int(ku.shape[0]), int(kr.shape[0])
