"""The latent-voxel map, plainly: a dense grid of cells, each with a flag
(allocated), an observation count and a latent code.

Fusing a keyframe's world-space points and normals: cells with more than
``prune_min_vox_obs`` of the frame's points survive; surviving cells and
their 6 neighbours are allocated (on the dense map only the neighbours of
surviving cells not allocated before, as DI-Fusion's dense indexer does);
a point takes part when its cell neighbours a cell that is allocated and
still under ``encoder_count_th`` observations ("eligible"); each taking
point is encoded, relative to the centre of each of the 8 cells whose
centres surround it, with its normal, and every eligible cell among them
folds the codes into its running mean.

``dense``: the configuration's bounds (cell ``ceil((x - min) / s) - 1``,
clamped neighbours at the border); ``hash``: unbounded cells
``ceil(x / s) - 1``, held here in a grid over a box the lap cannot leave.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .frames import f32_recip

OFFSETS8 = [(-0.5, -0.5, -0.5), (-0.5, -0.5, 0.5), (-0.5, 0.5, -0.5), (-0.5, 0.5, 0.5),
            (0.5, -0.5, -0.5), (0.5, -0.5, 0.5), (0.5, 0.5, -0.5), (0.5, 0.5, 0.5)]


class VoxelMap:
    def __init__(self, cfg: Dict, prior, device):
        mp = cfg["mapping"]
        self.vs = float(mp["voxel_size"])
        self.dense = "bound_min" in mp and mp.get("indexer") != "hash"
        if self.dense:
            self.origin = [float(b) for b in mp["bound_min"]]
            self.n = [int(np.ceil((b1 - b0) / self.vs))
                      for b0, b1 in zip(mp["bound_min"], mp["bound_max"])]
            self.shift = [0, 0, 0]
        else:
            # cells of the unbounded map, offset into a grid around the lap
            fr = cfg["frames"]
            reach = [fr["radii"][0] + 4.0, fr["radii"][1] + 4.0]
            lo = [fr["center"][0] - reach[0], fr["center"][1] - reach[1], -1.0]
            hi = [fr["center"][0] + reach[0], fr["center"][1] + reach[1], 7.0]
            self.origin = [0.0, 0.0, 0.0]
            self.shift = [int(np.floor(a / self.vs)) for a in lo]
            self.n = [int(np.ceil(b / self.vs)) - s + 1 for b, s in zip(hi, self.shift)]
        self.prune = int(mp["prune_min_vox_obs"])
        self.ignore = float(mp["ignore_count_th"])
        self.enc_th = float(mp["encoder_count_th"])
        self.prior = prior
        self.device = device
        n_cells = int(np.prod(self.n))
        L = int(prior.hyper["code_length"])
        self.alloc = torch.zeros(n_cells, dtype=torch.bool, device=device)
        self.count = torch.zeros(n_cells, device=device)
        self.latent = torch.zeros(n_cells, L, device=device)

    # -- cells ------------------------------------------------------------
    def normalized(self, x: torch.Tensor) -> torch.Tensor:
        if self.dense:
            return (x - torch.tensor(self.origin, device=x.device)) * f32_recip(self.vs)
        return x * f32_recip(self.vs)

    def _index(self, cell: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Grid index of integer cells, and whether they lie in the grid."""
        g = cell - torch.tensor(self.shift, device=cell.device)
        n = torch.tensor(self.n, device=cell.device)
        inside = torch.all((g >= 0) & (g < n), dim=-1)
        g = torch.minimum(torch.clamp(g, min=0), n - 1)
        return (g[..., 0] * self.n[1] + g[..., 1]) * self.n[2] + g[..., 2], inside

    def _dilate6(self, flag: torch.Tensor) -> torch.Tensor:
        f = flag.reshape(self.n)
        out = f.clone()
        out[1:] |= f[:-1]
        out[:-1] |= f[1:]
        out[:, 1:] |= f[:, :-1]
        out[:, :-1] |= f[:, 1:]
        out[:, :, 1:] |= f[:, :, :-1]
        out[:, :, :-1] |= f[:, :, 1:]
        return out.reshape(-1)

    # -- fusion -----------------------------------------------------------
    def fuse(self, pts: torch.Tensor, nrm: torch.Tensor, mask: torch.Tensor) -> None:
        pn = self.normalized(pts)
        cell = torch.ceil(pn).to(torch.int64) - 1
        idx, inside = self._index(cell)
        if not self.dense and bool((mask & ~inside).any()):
            raise ValueError("a point left the reference's grid")
        valid = mask & inside
        n_cells = self.alloc.shape[0]
        per_cell = torch.bincount(idx[valid], minlength=n_cells)
        keep = valid & (per_cell[idx] > self.prune)
        surviving = torch.bincount(idx[keep], minlength=n_cells) > 0
        if self.dense:
            self.alloc |= self._dilate6(surviving & ~self.alloc)
        else:
            self.alloc |= self._dilate6(surviving)
        elig = self.alloc & (self.count < self.enc_th)
        focus = keep & self._dilate6(elig)[idx]
        off = torch.tensor(OFFSETS8, device=pts.device)
        ng = torch.ceil(pn[:, None, :] + off[None]) - 1
        if self.dense:
            ng = torch.minimum(torch.clamp(ng, min=0),
                               torch.tensor(self.n, device=pts.device, dtype=ng.dtype) - 1)
        rel = pn[:, None, :] - ng - 0.5
        ng_idx, ng_in = self._index(ng.to(torch.int64))
        contrib = focus[:, None] & ng_in & elig[ng_idx]
        rows = torch.cat([rel, nrm[:, None, :].expand(-1, 8, -1)], dim=-1)[contrib]
        codes = self.prior.encode(rows)
        tgt = ng_idx[contrib]
        sums = torch.zeros_like(self.latent).index_add_(0, tgt, codes)
        cnts = torch.zeros_like(self.count).index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.float32))
        new = self.count + cnts
        fused = (sums + self.latent * self.count[:, None]) / torch.clamp(new, min=1e-12)[:, None]
        self.latent = torch.where((cnts > 0)[:, None], fused, self.latent)
        self.count = new
        self.last_touched = cnts > 0

    # -- queries ------------------------------------------------------------
    def gather(self, x: torch.Tensor):
        """Latent of each point's cell, its cell-centre-relative position in
        voxels, and whether the cell is allocated and observed more than
        ``ignore_count_th`` times."""
        pn = self.normalized(x)
        cell = torch.ceil(pn).to(torch.int64) - 1
        idx, inside = self._index(cell)
        valid = inside & self.alloc[idx] & (self.count[idx] > self.ignore)
        lat = torch.where(valid[:, None], self.latent[idx], torch.zeros((), device=x.device))
        return lat, pn - cell.to(pn.dtype) - 0.5, valid

    def cells(self) -> torch.Tensor:
        """(n, 3) integer cells of the grid, in grid order."""
        ar = [torch.arange(n, device=self.device) + s for n, s in zip(self.n, self.shift)]
        g = torch.stack(torch.meshgrid(*ar, indexing="ij"), dim=-1)
        return g.reshape(-1, 3)
