"""Dense latent voxel map as fixed-capacity tensor state (counterpart of
difusion_tpu/core/map.py:40-280 and its save/load, :477-504).

A bounded scene is a dense cell grid; ``indexer`` maps each cell to a latent
slot (-1 free).  Fusion allocates slots in cell order with a prefix sum,
encodes each observed point into the 8 voxels around it and folds the codes
into each voxel's running mean.  Every step is a fixed-shape tensor op, so a
fusion makes no device-to-host sync.  :func:`save_map` / :func:`load_map`
carry map state across the two packages in the JAX package's npz format.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import const, resolve_device
from ..models.encoder import Encoder
from ..ops.imgproc import recip


class MapConfig(NamedTuple):
    """Static map geometry and thresholds."""
    bound_min: Tuple[float, float, float]
    n_xyz: Tuple[int, int, int]
    voxel_size: float
    latent_dim: int = 29
    capacity: int = 1 << 15
    prune_min_vox_obs: int = 16
    ignore_count_th: float = 16.0
    encoder_count_th: float = 600.0

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.n_xyz))

    @classmethod
    def from_args(cls, args, latent_dim: int = 29, capacity: int = 1 << 15) -> "MapConfig":
        """Build from a reference-style mapping config namespace
        (bound_min/bound_max/voxel_size/prune_min_vox_obs/...)."""
        bound_min = tuple(float(b) for b in args.bound_min)
        n_xyz = tuple(int(np.ceil((bmax - bmin) / args.voxel_size))
                      for bmin, bmax in zip(bound_min, args.bound_max))
        return cls(
            bound_min=bound_min, n_xyz=n_xyz, voxel_size=float(args.voxel_size),
            latent_dim=latent_dim, capacity=capacity,
            prune_min_vox_obs=int(getattr(args, "prune_min_vox_obs", 16)),
            ignore_count_th=float(getattr(args, "ignore_count_th", 16.0)),
            encoder_count_th=float(getattr(args, "encoder_count_th", 600.0)))


class MapState(NamedTuple):
    """Device-resident map state."""
    indexer: torch.Tensor     # (n_cells,) int32: cell -> latent slot, -1 free
    latents: torch.Tensor     # (capacity, L) f32
    positions: torch.Tensor   # (capacity,) int32: slot -> cell id, -1 free
    obs_count: torch.Tensor   # (capacity,) f32
    mesh_dirty: torch.Tensor  # (capacity,) bool: touched since last meshing
    n_occupied: torch.Tensor  # () int32
    overflow: torch.Tensor    # () int32: allocations dropped for capacity


def create_map_state(cfg: MapConfig, device) -> MapState:
    i32 = dict(dtype=torch.int32, device=device)
    return MapState(
        indexer=torch.full((cfg.n_cells,), -1, **i32),
        latents=torch.zeros(cfg.capacity, cfg.latent_dim, device=device),
        positions=torch.full((cfg.capacity,), -1, **i32),
        obs_count=torch.zeros(cfg.capacity, device=device),
        mesh_dirty=torch.zeros(cfg.capacity, dtype=torch.bool, device=device),
        n_occupied=torch.zeros((), **i32),
        overflow=torch.zeros((), **i32),
    )
create_state = create_map_state
# the fields of a state that tracking reads
TRACKED_FIELDS = ("indexer", "latents", "obs_count")


def linearize(cfg: MapConfig, xyz_id: torch.Tensor) -> torch.Tensor:
    """(..., 3) integer cell coords -> (...,) linear id."""
    _, ny, nz = cfg.n_xyz
    return xyz_id[..., 2] + nz * xyz_id[..., 1] + (nz * ny) * xyz_id[..., 0]


def unlinearize(cfg: MapConfig, idx: torch.Tensor) -> torch.Tensor:
    """(...,) linear id -> (..., 3) integer cell coords."""
    _, ny, nz = cfg.n_xyz
    return torch.stack([idx // (ny * nz), (idx // nz) % ny, idx % nz], dim=-1)


def normalize_points(cfg: MapConfig, xyz: torch.Tensor) -> torch.Tensor:
    return ((xyz - const(cfg.bound_min, xyz.device, xyz.dtype))
            * recip(cfg.voxel_size))


def cell_of(xyz_normalized: torch.Tensor) -> torch.Tensor:
    """Voxel id of a normalized point (ceil - 1)."""
    return torch.ceil(xyz_normalized).to(torch.int64) - 1


def in_bounds(cfg: MapConfig, cell: torch.Tensor) -> torch.Tensor:
    n = const(cfg.n_xyz, cell.device, torch.int64)
    return torch.all((cell >= 0) & (cell < n), dim=-1)


def dilate6(cfg: MapConfig, flag: torch.Tensor) -> torch.Tensor:
    """6-neighbourhood dilation of a (n_cells,) bool grid (no wrap)."""
    f = flag.reshape(cfg.n_xyz)
    out = f.clone()
    out[1:] |= f[:-1]
    out[:-1] |= f[1:]
    out[:, 1:] |= f[:, :-1]
    out[:, :-1] |= f[:, 1:]
    out[:, :, 1:] |= f[:, :, :-1]
    out[:, :, :-1] |= f[:, :, 1:]
    return out.reshape(-1)


_INTEGRATION_OFFSETS = (
    (-0.5, -0.5, -0.5), (-0.5, -0.5, 0.5), (-0.5, 0.5, -0.5), (-0.5, 0.5, 0.5),
    (0.5, -0.5, -0.5), (0.5, -0.5, 0.5), (0.5, 0.5, -0.5), (0.5, 0.5, 0.5))


def integrate_keyframe(cfg: MapConfig, encoder: Encoder, state: MapState,
                       surface_xyz: torch.Tensor, surface_normal: torch.Tensor,
                       valid: torch.Tensor) -> MapState:
    """Fuse one keyframe's observations into the map: prune sparsely
    observed voxels, allocate new voxels (6-dilated), encode every point in
    the 8 voxels around it and fold the codes into each voxel's running mean.
    ``surface_xyz`` (N, 3) world coords, ``surface_normal`` (N, 3),
    ``valid`` (N,).  Returns a new state; the input state is not modified.

    The per-voxel code sums (:func:`_segment_sum`) add in another order than
    the JAX package's, so latents agree with it to f32 rounding, not bit for
    bit; two runs of the port on one device agree bit for bit."""
    dev = surface_xyz.device
    n = surface_xyz.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    pn = normalize_points(cfg, surface_xyz)
    cell = cell_of(pn)
    valid = valid & in_bounds(cfg, cell)
    lin = torch.clamp(linearize(cfg, cell), 0, cfg.n_cells - 1)

    # 1. prune sparsely observed voxels
    cell_counts = torch.zeros(cfg.n_cells, **i32).index_add_(
        0, lin, valid.to(torch.int32))
    keep = valid & (cell_counts[lin] > cfg.prune_min_vox_obs)

    # 2. allocate new voxels, expanded by the 6-neighbourhood
    surviving = torch.zeros(cfg.n_cells, **i32).index_add_(
        0, lin, keep.to(torch.int32)) > 0
    free = state.indexer < 0
    alloc_flag = dilate6(cfg, surviving & free) & free
    order = torch.cumsum(alloc_flag.to(torch.int32), 0, dtype=torch.int32)
    slot = state.n_occupied + order - 1
    alloc_ok = alloc_flag & (slot < cfg.capacity)
    indexer = torch.where(alloc_ok, slot, state.indexer)
    cell_ids = torch.arange(cfg.n_cells, **i32)
    scatter_slot = torch.where(alloc_ok, slot, cfg.capacity).to(torch.int64)
    positions = torch.cat([state.positions, state.positions.new_full((1,), -1)])
    positions = positions.scatter(0, scatter_slot, cell_ids)[:cfg.capacity]
    n_alloc = order[-1]
    n_occupied = torch.clamp(state.n_occupied + n_alloc, max=cfg.capacity)
    overflow = state.overflow + torch.clamp(
        state.n_occupied + n_alloc - cfg.capacity, min=0)

    # 3. encoder-eligible voxels: allocated and not yet converged
    slot_of_cell = torch.clamp(indexer, 0, cfg.capacity - 1).to(torch.int64)
    enc_cell = (indexer >= 0) & (state.obs_count[slot_of_cell]
                                 < cfg.encoder_count_th)
    # focus prune: a point participates iff its voxel is in the 6-dilation
    # of the encoder-voxel set
    focus = keep & dilate6(cfg, enc_cell)[lin]

    # 4. the 8 voxels around every point
    offsets = const(_INTEGRATION_OFFSETS, dev)
    ng = torch.ceil(pn[:, None, :] + offsets[None]) - 1          # (N, 8, 3)
    ng = torch.minimum(torch.clamp(ng, min=0),
                       const(cfg.n_xyz, dev, pn.dtype) - 1)
    rel = pn[:, None, :] - ng - 0.5
    ng_lin = linearize(cfg, ng.to(torch.int64))                   # (N, 8)
    tgt_slot = indexer[ng_lin]
    contrib = focus[:, None] & enc_cell[ng_lin]
    seg = torch.where(contrib, tgt_slot, cfg.capacity).reshape(-1).to(torch.int64)

    xyzn = torch.cat([rel, surface_normal[:, None, :].expand(-1, 8, -1)],
                     dim=-1).reshape(n * 8, 6)
    codes = encoder.encode_points(xyzn)                           # (N*8, L)
    w = contrib.reshape(-1).to(codes.dtype)
    sums = _segment_sum(cfg.capacity + 1, seg, codes * w[:, None])[:-1]
    cnts = _segment_sum(cfg.capacity + 1, seg, w)[:-1]

    # 5. weighted running-mean fusion
    new_count = state.obs_count + cnts
    denom = torch.clamp(new_count, min=1e-12)
    fused = (sums + state.latents * state.obs_count[:, None]) / denom[:, None]
    touched = cnts > 0
    latents = torch.where(touched[:, None], fused, state.latents)
    return MapState(indexer=indexer, latents=latents, positions=positions,
                    obs_count=new_count, mesh_dirty=state.mesh_dirty | touched,
                    n_occupied=n_occupied, overflow=overflow)


def _segment_sum(n_out: int, seg: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Sum the rows of ``values`` by segment id into ``n_out`` rows.  On the
    card ``index_add_`` adds with atomics, in an order that changes from run
    to run; ``index_put_(accumulate=True)`` sorts the ids and adds every
    segment in row order, so a fusion gives the same bits on every run.  On
    the CPU ``index_add_`` already adds in row order."""
    out = torch.zeros((n_out, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    if values.is_cuda:
        return out.index_put_((seg,), values, accumulate=True)
    return out.index_add_(0, seg, values)


def latent_count_table(state: MapState) -> torch.Tensor:
    """(capacity, L+1) latents with ``obs_count`` as the last column, so an
    SDF query needs one row gather."""
    return torch.cat([state.latents, state.obs_count[:, None]], dim=1)


def gather_latent_rel(cfg: MapConfig, state: MapState, xyz: torch.Tensor,
                      aug_table: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Voxel lookup + latent gather + voxel-local coordinates of world
    points.  Returns (latent (N, L), rel (N, 3), valid (N,));
    ``d rel / d xyz = 1 / voxel_size``."""
    pn = normalize_points(cfg, xyz)
    cell = cell_of(pn)
    inside = in_bounds(cfg, cell)
    lin = torch.clamp(linearize(cfg, cell), 0, cfg.n_cells - 1)
    slot = state.indexer[lin]
    slot_safe = torch.clamp(slot, 0, cfg.capacity - 1).to(torch.int64)
    row = aug_table[slot_safe]
    valid = inside & (slot >= 0) & (row[:, -1] > cfg.ignore_count_th)
    latent = torch.where(valid[:, None], row[:, :-1],
                         torch.zeros((), dtype=row.dtype, device=row.device))
    rel = pn - cell.to(pn.dtype) - 0.5
    return latent, rel, valid


_CFG_FIELDS = ("bound_min", "n_xyz", "voxel_size", "latent_dim", "capacity",
               "prune_min_vox_obs", "ignore_count_th", "encoder_count_th")


def save_map(path, cfg: MapConfig, state: MapState) -> None:
    """Write the map as the JAX package's ``save_map`` does (npz with
    ``state.*`` and ``cfg.*`` keys), so its ``load_map`` reads it."""
    arrays = {f"state.{name}": getattr(state, name).cpu().numpy()
              for name in MapState._fields}
    # the JAX package's MapState also carries the latent optimizer's fields,
    # which the port does not run: written as zeros, ignored on load
    arrays["state.optimized"] = np.zeros(cfg.capacity, bool)
    arrays["state.opt_overflow"] = np.zeros((), np.int32)
    arrays.update({f"cfg.{name}": np.asarray(getattr(cfg, name)) for name in _CFG_FIELDS})
    np.savez_compressed(path, **arrays)


def load_map(path, device="cuda") -> Tuple[MapConfig, MapState]:
    """Read a map npz written by either package onto ``device``: a dense
    one here, a hash-map snapshot through :func:`.hash_map.load_map`."""
    dev = resolve_device(device)
    with np.load(path) as data:
        if "cfg.table_size" in data:
            from . import hash_map
            return hash_map.load_map(path, device=dev)
        cfg = MapConfig(
            bound_min=tuple(float(x) for x in data["cfg.bound_min"]),
            n_xyz=tuple(int(x) for x in data["cfg.n_xyz"]),
            voxel_size=float(data["cfg.voxel_size"]),
            latent_dim=int(data["cfg.latent_dim"]),
            capacity=int(data["cfg.capacity"]),
            prune_min_vox_obs=int(data["cfg.prune_min_vox_obs"]),
            ignore_count_th=float(data["cfg.ignore_count_th"]),
            encoder_count_th=float(data["cfg.encoder_count_th"]))
        state = MapState(**{name: torch.from_numpy(data[f"state.{name}"]).to(dev)
                            for name in MapState._fields})
    return cfg, state
