"""Dense latent voxel map as fixed-capacity tensor state (counterpart of
difusion_tpu/core/map.py: the state, fusion, SDF queries, latent
optimization and save/load).

A bounded scene is a dense cell grid; ``indexer`` maps each cell to a latent
slot (-1 free).  Fusion allocates slots in cell order with a prefix sum,
encodes each observed point into the 8 voxels around it and folds the codes
into each voxel's running mean.  Every step is a fixed-shape tensor op, so a
fusion makes no device-to-host sync.  :func:`optimize_latents` refines the
latents of converged voxels against noisy pseudo-SDF samples around the
surface (:func:`build_optimize_samples`), and :func:`merge_optimize_result`
folds a result computed from an older state into the current one.
:func:`save_map` / :func:`load_map` carry map state across the two packages
in the JAX package's npz format.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import const, resolve_device
from ..models.decoder import Decoder
from ..models.encoder import Encoder
from ..ops.imgproc import recip
from ..ops.segment import padded_unique_inverse
from ..utils.adam import adam_step, bias_corrections


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

    @property
    def bound_max(self) -> Tuple[float, float, float]:
        return tuple(b + n * self.voxel_size for b, n in zip(self.bound_min, self.n_xyz))

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
    optimized: torch.Tensor   # (capacity,) bool: latent refined by the optimizer
    mesh_dirty: torch.Tensor  # (capacity,) bool: touched since last meshing
    n_occupied: torch.Tensor  # () int32
    overflow: torch.Tensor    # () int32: allocations dropped for capacity
    opt_overflow: torch.Tensor  # () int32: touched slots beyond the optimizer's
    #                             working table (they kept their fused values)


def create_map_state(cfg: MapConfig, device) -> MapState:
    i32 = dict(dtype=torch.int32, device=device)
    return MapState(
        indexer=torch.full((cfg.n_cells,), -1, **i32),
        latents=torch.zeros(cfg.capacity, cfg.latent_dim, device=device),
        positions=torch.full((cfg.capacity,), -1, **i32),
        obs_count=torch.zeros(cfg.capacity, device=device),
        optimized=torch.zeros(cfg.capacity, dtype=torch.bool, device=device),
        mesh_dirty=torch.zeros(cfg.capacity, dtype=torch.bool, device=device),
        n_occupied=torch.zeros((), **i32),
        overflow=torch.zeros((), **i32),
        opt_overflow=torch.zeros((), **i32),
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
    return state._replace(indexer=indexer, latents=latents, positions=positions,
                          obs_count=new_count, mesh_dirty=state.mesh_dirty | touched,
                          n_occupied=n_occupied, overflow=overflow)


def _segment_plan(seg: torch.Tensor, n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, bounds) of segment ids in [0, n_out): the stable sort's
    permutation, and where each segment starts in sorted order ((n_out + 1,),
    the last entry N).  For several :func:`_segment_sum` calls over the same
    ids."""
    sorted_seg, order = torch.sort(seg, stable=True)
    return order, torch.searchsorted(sorted_seg, torch.arange(n_out + 1, device=seg.device))


def _segment_sum(n_out: int, seg: torch.Tensor, values: torch.Tensor,
                 plan: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Sum the rows of ``values`` by segment id into ``n_out`` rows.  On the
    CPU ``index_add_`` adds in row order, as the JAX package's XLA does
    there.  On the card ``index_add_`` adds with atomics, in an order that
    changes from run to run, and ``index_put_(accumulate=True)`` adds each
    segment's rows one after another in one warp (milliseconds for a
    segment of thousands); here the rows sort by segment once
    (:func:`_segment_plan`, or ``plan``) and every (segment, column) sums
    in CUB's segmented reduction: a fixed tree, the same bits every run."""
    if not values.is_cuda:
        out = torch.zeros((n_out, *values.shape[1:]), dtype=values.dtype,
                          device=values.device)
        return out.index_add_(0, seg, values)
    return _sorted_segment_sum(n_out, values, plan if plan is not None
                               else _segment_plan(seg, n_out))


def _sorted_segment_sum(n_out: int, values: torch.Tensor,
                        plan: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """:func:`_segment_sum` by a plan: the rows in segment order, one column
    after another, reduced segment by segment."""
    order, bounds = plan
    n = order.shape[0]
    cols = values[order].reshape(n, -1).t().contiguous()          # (W, N)
    width = cols.shape[0]
    offsets = bounds[None, :-1] + n * torch.arange(width, device=cols.device)[:, None]
    offsets = torch.cat([offsets.reshape(-1), offsets.new_full((1,), width * n)])
    sums = torch.segment_reduce(cols.reshape(-1), "sum", offsets=offsets, unsafe=True,
                                initial=0.0)
    return sums.reshape(width, n_out).t().reshape(n_out, *values.shape[1:])


def latent_count_table(state: MapState) -> torch.Tensor:
    """(capacity, L+1) latents with ``obs_count`` as the last column, so an
    SDF query needs one row gather."""
    return torch.cat([state.latents, state.obs_count[:, None]], dim=1)


def _voxel_lookup(cfg: MapConfig, state: MapState, xyz: torch.Tensor):
    """World points -> (normalized points, cell, inside the bounds, slot
    (-1 free), slot clamped to the table as int64)."""
    pn = normalize_points(cfg, xyz)
    cell = cell_of(pn)
    inside = in_bounds(cfg, cell)
    lin = torch.clamp(linearize(cfg, cell), 0, cfg.n_cells - 1)
    slot = state.indexer[lin]
    return pn, cell, inside, slot, torch.clamp(slot, 0, cfg.capacity - 1).to(torch.int64)


def gather_latent_rel(cfg: MapConfig, state: MapState, xyz: torch.Tensor,
                      aug_table: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Voxel lookup + latent gather + voxel-local coordinates of world
    points.  Returns (latent (N, L), rel (N, 3), valid (N,));
    ``d rel / d xyz = 1 / voxel_size``."""
    pn, cell, inside, slot, slot_safe = _voxel_lookup(cfg, state, xyz)
    row = aug_table[slot_safe]
    valid = inside & (slot >= 0) & (row[:, -1] > cfg.ignore_count_th)
    latent = torch.where(valid[:, None], row[:, :-1],
                         torch.zeros((), dtype=row.dtype, device=row.device))
    rel = pn - cell.to(pn.dtype) - 0.5
    return latent, rel, valid


def gather_slot_rel(cfg: MapConfig, state: MapState, xyz: torch.Tensor,
                    aug_table: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`gather_latent_rel` with each point's latent slot in place of
    its latent: (slot (N,) int32, 0 where the point is invalid, rel (N, 3),
    valid (N,)), for a decoder that reads a per-slot table (onet_cbn's and
    pigan_film's conditioning)."""
    pn, cell, inside, slot, slot_safe = _voxel_lookup(cfg, state, xyz)
    valid = inside & (slot >= 0) & (aug_table[slot_safe, -1] > cfg.ignore_count_th)
    rel = pn - cell.to(pn.dtype) - 0.5
    return torch.where(valid, slot_safe, 0).to(torch.int32), rel, valid


def query_sdf(cfg: MapConfig, decoder: Decoder, state: MapState, xyz: torch.Tensor,
              compute_dtype: torch.dtype = torch.float32
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sdf, std, valid) of world points through the decoder (in
    ``compute_dtype``, :meth:`~..models.decoder.Decoder.decode`); an invalid
    point decodes a zero latent and is masked downstream."""
    latent, rel, valid = gather_latent_rel(cfg, state, xyz, latent_count_table(state))
    sdf, std = decoder.decode(latent, rel, compute_dtype=compute_dtype)
    return sdf, std, valid


# ---------------------------------------------------------------------------
# Latent optimization
# ---------------------------------------------------------------------------


def build_optimize_samples(cfg: MapConfig, state: MapState, surface_xyz: torch.Tensor,
                           surface_normal: torch.Tensor, valid: torch.Tensor,
                           noise: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Noisy pseudo-SDF samples for the converged, not yet optimized voxels
    around a keyframe's surface: each point slides along its normal by
    ``0.05 * noise`` ((N, 8) standard normal draws, one per point and
    voxel of the 8 around it), which is the sample's target SDF.  The JAX
    package draws the noise inside the function; here the caller passes it.
    Returns (slot_ids (N*8,) int32, capacity where unused; rel_xyz
    (N*8, 3); gt_sdf (N*8,); mask (N*8,))."""
    dev = surface_xyz.device
    pn = normalize_points(cfg, surface_xyz)
    cell = cell_of(pn)
    valid = valid & in_bounds(cfg, cell)
    lin = torch.clamp(linearize(cfg, cell), 0, cfg.n_cells - 1)
    slot_of_cell = torch.clamp(state.indexer, 0, cfg.capacity - 1).to(torch.int64)
    optim_cell = ((state.indexer >= 0)
                  & (state.obs_count[slot_of_cell] >= cfg.encoder_count_th)
                  & ~state.optimized[slot_of_cell])
    focus = valid & dilate6(cfg, optim_cell)[lin]

    ng = torch.ceil(pn[:, None, :] + const(_INTEGRATION_OFFSETS, dev)[None]) - 1
    ng = torch.minimum(torch.clamp(ng, min=0), const(cfg.n_xyz, dev, pn.dtype) - 1)
    rel = pn[:, None, :] - ng - 0.5
    ng_lin = linearize(cfg, ng.to(torch.int64))
    contrib = focus[:, None] & optim_cell[ng_lin]
    return noisy_samples(contrib, state.indexer[ng_lin], rel, surface_normal, noise,
                         cfg.capacity)


def noisy_samples(contrib: torch.Tensor, slot: torch.Tensor, rel: torch.Tensor,
                  surface_normal: torch.Tensor, noise: torch.Tensor, capacity: int):
    """The samples' common tail (dense and hash map): targets, the slide
    along the normal, flattening."""
    gt_sdf = noise * 0.05
    rel = rel + gt_sdf[..., None] * surface_normal[:, None, :]
    return (torch.where(contrib, slot.to(torch.int32), capacity).reshape(-1),
            rel.reshape(-1, 3), gt_sdf.reshape(-1), contrib.reshape(-1))


def _bias_corrections(n_iters: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1 - b1^t, 1 - b2^t) for t = 1..n_iters in f32, on the device."""
    return tuple(const(tuple(bc.tolist()), device)
                 for bc in bias_corrections(np.arange(1, n_iters + 1)))


def _loss_grad(decoder: Decoder, table: torch.Tensor, comp: torch.Tensor, plan,
               rel_xyz: torch.Tensor, gt: torch.Tensor, in_budget: torch.Tensor,
               n_samples: torch.Tensor) -> torch.Tensor:
    """d loss / d table of the clamped Gaussian NLL (its constant 0.5 log 2 pi
    has no gradient).  The decode's backward runs to the per-sample
    latents, which then sum by compact row through :func:`_segment_sum`
    (``plan``: the rows' sort, made once a call)."""
    with torch.enable_grad():
        lat = table[comp].requires_grad_(True)
        sdf, std = decoder.decode(lat, rel_xyz)
        pd = torch.clamp(sdf, -0.2, 0.2)
        ll = 0.5 * ((gt - pd) / std) ** 2 + torch.log(std)
        loss = torch.sum(ll * in_budget) / n_samples
        g_lat, = torch.autograd.grad(loss, lat)
    return _segment_sum(table.shape[0], comp, g_lat, plan)


def optimize_latents(cfg, decoder: Decoder, state, slot_ids: torch.Tensor,
                     rel_xyz: torch.Tensor, gt_sdf: torch.Tensor, mask: torch.Tensor,
                     n_iters: int = 20, lr: float = 1e-2, code_reg_lambda: float = 0.0,
                     max_slots: int = 2048):
    """Adam over the latents of the slots that ``slot_ids`` touches, against
    the clamped NLL of the samples (dense and hash map alike: only slots
    matter).  The touched slots compact into a (max_slots + 1, L) table (a
    sort-based unique; the last row takes the invalid samples and the
    slots beyond the budget, and is never written back); ``n_iters`` Adam
    steps run on it as optax computes them; the rows scatter back, marked
    ``optimized`` and ``mesh_dirty``.  Touched slots beyond ``max_slots``
    keep their fused values and add to ``opt_overflow``.  The gradient is
    autograd through ``Decoder.decode``.  Nothing here reads the device."""
    capacity = state.latents.shape[0]
    n_samples = torch.clamp(mask.sum(), min=1).to(torch.float32)
    uq = padded_unique_inverse(slot_ids, valid=mask)
    comp = torch.clamp(uq.inverse, max=max_slots)
    in_budget = mask.to(torch.float32) * (uq.inverse < max_slots)
    # the slot of each compact row, -1 for an empty one
    row_slot = torch.full((max_slots + 1,), -1, dtype=torch.int64,
                          device=slot_ids.device).scatter_reduce(
        0, comp, torch.where(mask, slot_ids.to(torch.int64), -1), "amax")[:-1]
    row_live = row_slot >= 0
    row_slot_safe = torch.clamp(row_slot, 0, capacity - 1)
    table = torch.cat([state.latents[row_slot_safe] * row_live[:, None],
                       state.latents.new_zeros(1, state.latents.shape[1])])
    gt = torch.clamp(gt_sdf, -0.2, 0.2)
    plan = _segment_plan(comp, max_slots + 1) if comp.is_cuda else None
    bc1, bc2 = _bias_corrections(n_iters, table.device)
    mu, nu = torch.zeros_like(table), torch.zeros_like(table)
    for t in range(n_iters):
        g = _loss_grad(decoder, table, comp, plan, rel_xyz, gt, in_budget, n_samples)
        if code_reg_lambda > 0:
            with torch.enable_grad():
                leaf = table.detach().requires_grad_(True)
                reg = code_reg_lambda * torch.sum(
                    torch.linalg.vector_norm(leaf[:-1], dim=1) * row_live) / n_samples
                g = g + torch.autograd.grad(reg, leaf)[0]
        table, mu, nu = adam_step(table, g, mu, nu, bc1[t], bc2[t], lr)

    scatter_slot = torch.where(row_live, row_slot_safe, capacity)
    latents = scatter_drop(state.latents, scatter_slot,
                           torch.where(row_live[:, None], table[:-1], 0.0))
    touched = scatter_drop(torch.zeros_like(state.optimized), scatter_slot,
                           torch.ones_like(row_live))
    n_over = torch.clamp(uq.count - max_slots, min=0).to(torch.int32)
    return state._replace(latents=latents, optimized=state.optimized | touched,
                          mesh_dirty=state.mesh_dirty | touched,
                          opt_overflow=state.opt_overflow + n_over)


def merge_optimize_result(state, old_latents: torch.Tensor, new_latents: torch.Tensor,
                          old_counts: torch.Tensor, touched: torch.Tensor):
    """Fold an optimizer result computed from an older state into the
    current one by delta de-integration: ``merged = (cur * n_cur + (new -
    old) * n_old) / n_cur``, the correction weighted by the observation
    count it was computed against, on top of whatever fused since.  Dense
    and hash map alike."""
    n_cur = torch.clamp(state.obs_count, min=1e-12)[:, None]
    merged = (state.latents * n_cur + (new_latents - old_latents) * old_counts[:, None]) / n_cur
    apply = touched & (state.obs_count > 0)
    return state._replace(latents=torch.where(apply[:, None], merged, state.latents),
                          optimized=state.optimized | apply,
                          mesh_dirty=state.mesh_dirty | apply)


def scatter_drop(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst`` with rows ``idx`` set to ``src``; an index of ``len(dst)``
    drops its row (the JAX ``.at[].set(mode="drop")``)."""
    ext = torch.cat([dst, dst[:1]])
    ext[idx] = src.to(dst.dtype)
    return ext[:-1]


_CFG_FIELDS = ("bound_min", "n_xyz", "voxel_size", "latent_dim", "capacity",
               "prune_min_vox_obs", "ignore_count_th", "encoder_count_th")


def save_map(path, cfg: MapConfig, state: MapState) -> None:
    """Write the map as the JAX package's ``save_map`` does (npz with
    ``state.*`` and ``cfg.*`` keys), so its ``load_map`` reads it."""
    arrays = {f"state.{name}": getattr(state, name).cpu().numpy()
              for name in MapState._fields}
    arrays.update({f"cfg.{name}": np.asarray(getattr(cfg, name)) for name in _CFG_FIELDS})
    np.savez_compressed(path, **arrays)


def state_arrays(data, fields, capacity: int) -> dict:
    """A saved state's arrays by field.  A file from before the latent
    optimizer's fields gives them as zeros: ``optimized`` (capacity,) bool
    (where the JAX ``load_map`` gives a scalar) and ``opt_overflow``."""
    missing = {"optimized": np.zeros(capacity, bool), "opt_overflow": np.zeros((), np.int32)}
    return {name: data[f"state.{name}"] if f"state.{name}" in data else missing[name]
            for name in fields}


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
        state = MapState(**{name: torch.from_numpy(a).to(dev) for name, a in
                            state_arrays(data, MapState._fields, cfg.capacity).items()})
    return cfg, state
