"""Map debug visuals (counterpart of difusion_tpu/core/visuals.py, the
reference's ``get_fast_preview_visuals`` / ``get_map_visuals``): occupied
block boxes and SDF / uncertainty samples over the occupied voxels as plain
numpy, dense and hash map, and a coloured point-cloud PLY writer."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.decoder import Decoder
from ..ops.sampling import get_samples
from . import hash_map as HM
from .meshing import jet_rgb


class MapVisuals(NamedTuple):
    block_starts: Optional[np.ndarray] = None    # (B, 3) world coords
    block_size: float = 0.0
    bound_min: Optional[np.ndarray] = None
    bound_max: Optional[np.ndarray] = None
    sample_xyz: Optional[np.ndarray] = None      # (S, 3)
    sample_sdf: Optional[np.ndarray] = None      # (S,) normalized [0, 1]
    sample_std: Optional[np.ndarray] = None      # (S,) normalized [0, 1]


def _occupied_cells(cfg, state) -> Tuple[np.ndarray, np.ndarray]:
    """-> (cells (B, 3) int, slots (B,)) of the confident occupied voxels."""
    if isinstance(cfg, HM.HashMapConfig):
        n = int(state.n_occupied)
        cells = state.slot_cell[:n].cpu().numpy()
        slots = np.arange(n)
    else:
        indexer = state.indexer.cpu().numpy()
        occupied = np.where(indexer >= 0)[0]
        slots = indexer[occupied]
        nx, ny, nz = cfg.n_xyz
        cells = np.stack([occupied // (ny * nz), (occupied // nz) % ny,
                          occupied % nz], axis=1)
    counts = state.obs_count.cpu().numpy()
    keep = counts[slots] > cfg.ignore_count_th
    return cells[keep], slots[keep]


def _world_origin(cfg) -> np.ndarray:
    if isinstance(cfg, HM.HashMapConfig):
        return np.zeros(3, np.float32)
    return np.asarray(cfg.bound_min, np.float32)


def get_fast_preview_visuals(cfg, state) -> MapVisuals:
    """Occupied-block wireframe data."""
    cells, _ = _occupied_cells(cfg, state)
    starts = cells * cfg.voxel_size + _world_origin(cfg)[None, :]
    bmin = bmax = None
    if not isinstance(cfg, HM.HashMapConfig):
        bmin = np.asarray(cfg.bound_min, np.float32)
        bmax = np.asarray(cfg.bound_max, np.float32)
    return MapVisuals(block_starts=starts.astype(np.float32),
                      block_size=cfg.voxel_size, bound_min=bmin, bound_max=bmax)


def get_map_visuals(cfg, decoder: Decoder, state, voxel_resolution: int = 8,
                    sample_range: Optional[list] = None) -> MapVisuals:
    """Dense SDF/uncertainty samples over the occupied voxels, decoded by
    :meth:`Decoder.decode` on the state's device (the JAX package decodes
    with its XLA ``decode``)."""
    cells, slots = _occupied_cells(cfg, state)
    if len(cells) == 0:
        return get_fast_preview_visuals(cfg, state)
    r = voxel_resolution
    lattice = np.asarray(get_samples(r)) - 0.5                 # (r^3, 3)
    latents = state.latents.cpu().numpy()[slots]                # (B, L)
    B, K = len(cells), lattice.shape[0]
    dev = state.latents.device
    lat = torch.from_numpy(np.repeat(latents, K, axis=0)).to(dev)
    xyz = torch.from_numpy(np.tile(lattice, (B, 1)).astype(np.float32)).to(dev)
    sdf, std = decoder.decode(lat, xyz)
    sdf = sdf.cpu().numpy()
    std = std.cpu().numpy()

    pos = (cells[:, None, :] + (lattice + 0.5)[None]) * cfg.voxel_size \
        + _world_origin(cfg)[None, None, :]
    pos = pos.reshape(-1, 3).astype(np.float32)

    if sample_range is None:
        lo, hi = sdf.min(), sdf.max()
        vis_sdf = (sdf - lo) / max(hi - lo, 1e-12)
        vis_std = (std - std.min()) / max(std.max() - std.min(), 1e-12)
    else:
        vis_sdf = np.clip((sdf - sample_range[0])
                          / (sample_range[1] - sample_range[0]), 0, 1)
        vis_std = np.clip((std - sample_range[0])
                          / (sample_range[1] - sample_range[0]), 0, 1)

    base = get_fast_preview_visuals(cfg, state)
    return base._replace(sample_xyz=pos, sample_sdf=vis_sdf, sample_std=vis_std)


def write_pointcloud_ply(path: str, xyz: np.ndarray, cfloat: np.ndarray) -> None:
    """Coloured point-cloud PLY (jet colormap over ``cfloat`` in [0, 1], the
    port's own table: the machine with the card has no matplotlib)."""
    colors = jet_rgb(np.clip(cfloat, 0, 1))
    rec = np.empty(len(xyz), np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)]))
    rec["xyz"] = xyz
    rec["rgb"] = colors
    with open(path, "wb") as f:
        f.write((
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(xyz)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n").encode())
        f.write(rec.tobytes())


def _decimate(verts, colors, faces, max_faces: int):
    if len(faces) <= max_faces:
        return verts, colors, faces
    keep = np.linspace(0, len(faces) - 1, max_faces).astype(np.int64)
    return verts, colors, faces[keep]


def view_matplotlib(verts, colors, faces, traj, gt, save: str) -> None:
    """Render a mesh and trajectories with matplotlib: a 3-D view and a
    top-down one, written to ``save`` (or shown).  The port's copy of
    tools/view.py's renderer; raises ImportError without matplotlib."""
    import matplotlib
    if save:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(14, 7))
    ax3 = fig.add_subplot(1, 2, 1, projection="3d")
    if len(faces):
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection
        verts, colors, faces = _decimate(verts, colors, faces, 40000)
        polys = verts[faces]                       # (F, 3, 3)
        if colors is not None:
            tri_col = colors[faces[:, 0]].astype(np.float32) / 255.0
        else:
            tri_col = np.tile([[0.6, 0.6, 0.7]], (len(faces), 1))
        coll = Poly3DCollection(polys, facecolors=tri_col, alpha=0.55,
                                linewidths=0.0)
        ax3.add_collection3d(coll)
        pts = [verts] + [t for t in (traj, gt) if t is not None]
        allp = np.concatenate(pts)
        lo, hi = allp.min(0), allp.max(0)
        ax3.set_xlim(lo[0], hi[0])
        ax3.set_ylim(lo[1], hi[1])
        ax3.set_zlim(lo[2], hi[2])
    if traj is not None:
        ax3.plot(traj[:, 0], traj[:, 1], traj[:, 2], "b-", lw=2, label="estimated")
        ax3.scatter(*traj[0], c="g", s=40, label="start")
        ax3.scatter(*traj[-1], c="r", s=40, label="end")
    if gt is not None:
        ax3.plot(gt[:, 0], gt[:, 1], gt[:, 2], "k--", lw=1.5, label="ground truth")
    ax3.set_title("reconstruction + trajectory")
    ax3.legend(loc="upper right")

    ax2 = fig.add_subplot(1, 2, 2)
    if len(faces):
        ax2.scatter(verts[:, 0], verts[:, 1], s=0.2, c="gray", alpha=0.4)
    if traj is not None:
        ax2.plot(traj[:, 0], traj[:, 1], "b-", lw=2)
    if gt is not None:
        ax2.plot(gt[:, 0], gt[:, 1], "k--", lw=1.5)
    ax2.set_aspect("equal")
    ax2.set_title("top-down (x-y)")
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=110)
        plt.close(fig)
        print(f"wrote {save}")
    else:
        plt.show()
