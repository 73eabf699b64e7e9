"""Hash-indexed latent voxel map for unbounded scenes (counterpart of
difusion_tpu/core/hash_map.py: the state, fusion, queries, the latent
optimizer's samples and save/load).

Voxels are keyed by integer cell coordinates in an open-addressing table of
fixed size with linear probing, so no scene bounds are needed up front.
Parallel insertion takes a few rounds of scatter-min claiming: every
pending key writes its rank to its probe position with
``scatter_reduce(..., "amin")`` (order-free), the winners write their keys,
and every pending key then re-reads its position -- a key match (its own
win, a duplicate cell's win or an entry that was there before) resolves it.

The slot arrays (``latents``, ``obs_count``, ``mesh_dirty``) have the dense
map's layout, so fusion and queries share its semantics; only cell -> slot
resolution differs.  Every step is a fixed-shape tensor op: a fusion makes no
device-to-host sync.  The hash is the JAX package's uint32 product hash,
computed in int64 (PyTorch has no general uint32 arithmetic): the low bits
of a product depend only on the low bits of its factors, so the table
position is the same.  Slots depend on insertion order; compare two maps by
cell, not by slot.
"""
from __future__ import annotations

import sys
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import const, resolve_device
from ..models.decoder import Decoder
from ..models.encoder import Encoder
from ..ops.imgproc import recip
from . import map as M

EMPTY = -2 ** 31                  # key sentinel (cell coords never reach it)
_HASH_PRIMES = (73856093, 19349663, 83492791)
_NEIGHBORS7 = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0),
               (0, -1, 0), (0, 0, 1), (0, 0, -1))


class HashMapConfig(NamedTuple):
    voxel_size: float
    latent_dim: int = 29
    capacity: int = 1 << 16          # latent slots
    table_size: int = 1 << 18        # hash entries (a power of two > capacity)
    n_probes: int = 8
    prune_min_vox_obs: int = 16
    ignore_count_th: float = 16.0
    encoder_count_th: float = 600.0

    @classmethod
    def from_args(cls, args, latent_dim: int = 29, capacity: int = 1 << 16,
                  table_size: int = 1 << 18) -> "HashMapConfig":
        return cls(voxel_size=float(args.voxel_size), latent_dim=latent_dim,
                   capacity=capacity, table_size=table_size,
                   prune_min_vox_obs=int(getattr(args, "prune_min_vox_obs", 16)),
                   ignore_count_th=float(getattr(args, "ignore_count_th", 16.0)),
                   encoder_count_th=float(getattr(args, "encoder_count_th", 600.0)))


class HashMapState(NamedTuple):
    """Device-resident hash map state."""
    keys: torch.Tensor        # (T, 3) int32 cell coords, EMPTY when free
    table_slot: torch.Tensor  # (T,) int32 latent slot, -1 when unassigned
    latents: torch.Tensor     # (capacity, L) f32
    slot_cell: torch.Tensor   # (capacity, 3) int32 reverse map, EMPTY when free
    obs_count: torch.Tensor   # (capacity,) f32
    optimized: torch.Tensor   # (capacity,) bool: latent refined by the optimizer
    mesh_dirty: torch.Tensor  # (capacity,) bool: touched since last meshing
    n_occupied: torch.Tensor  # () int32
    overflow: torch.Tensor    # () int32: inserts dropped (probes or capacity)
    opt_overflow: torch.Tensor  # () int32: the optimizer's working-table truncations


def create_hash_map_state(cfg: HashMapConfig, device) -> HashMapState:
    i32 = dict(dtype=torch.int32, device=device)
    return HashMapState(
        keys=torch.full((cfg.table_size, 3), EMPTY, **i32),
        table_slot=torch.full((cfg.table_size,), -1, **i32),
        latents=torch.zeros(cfg.capacity, cfg.latent_dim, device=device),
        slot_cell=torch.full((cfg.capacity, 3), EMPTY, **i32),
        obs_count=torch.zeros(cfg.capacity, device=device),
        optimized=torch.zeros(cfg.capacity, dtype=torch.bool, device=device),
        mesh_dirty=torch.zeros(cfg.capacity, dtype=torch.bool, device=device),
        n_occupied=torch.zeros((), **i32),
        overflow=torch.zeros((), **i32),
        opt_overflow=torch.zeros((), **i32),
    )


create_state = create_hash_map_state
# the fields of a state that tracking reads
TRACKED_FIELDS = ("keys", "table_slot", "latents", "obs_count")


def map_module(cfg):
    """The module that implements ``cfg``'s map: this one for a
    :class:`HashMapConfig`, :mod:`.map` for a dense config.  Both define
    ``create_state``, ``integrate_keyframe``, ``gather_latent_rel``,
    ``build_optimize_samples``, ``optimize_latents``,
    ``merge_optimize_result``, ``save_map`` and ``TRACKED_FIELDS``."""
    return sys.modules[__name__] if isinstance(cfg, HashMapConfig) else M


def cell_of(cfg: HashMapConfig, xyz: torch.Tensor) -> torch.Tensor:
    """World position -> int64 cell (ceil - 1, origin 0), dividing by the
    voxel size as the jitted reference does: times its f32 reciprocal."""
    return torch.ceil(xyz * recip(cfg.voxel_size)).to(torch.int64) - 1


def _hash(cfg: HashMapConfig, cell: torch.Tensor) -> torch.Tensor:
    """(..., 3) integer cells -> (...,) int64 table position."""
    c = cell.to(torch.int64) & 0xFFFFFFFF
    h = ((c[..., 0] * _HASH_PRIMES[0]) ^ (c[..., 1] * _HASH_PRIMES[1])
         ^ (c[..., 2] * _HASH_PRIMES[2]))
    return h & (cfg.table_size - 1)


def lookup(cfg: HashMapConfig, keys: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """(..., 3) cells -> (...,) int64 table position or -1: ``n_probes``
    linear probes; an empty entry ends the search."""
    flat = cells.reshape(-1, 3)
    h = _hash(cfg, flat)
    pos = torch.full((flat.shape[0],), -1, dtype=torch.int64, device=flat.device)
    done = torch.zeros(flat.shape[0], dtype=torch.bool, device=flat.device)
    for r in range(cfg.n_probes):
        p = (h + r) & (cfg.table_size - 1)
        k = keys[p]
        match = torch.all(k == flat, dim=-1)
        pos = torch.where(~done & match, p, pos)
        done = done | match | (k[:, 0] == EMPTY)
    return pos.reshape(cells.shape[:-1])


def insert(cfg: HashMapConfig, state: HashMapState, cells: torch.Tensor,
           want: torch.Tensor) -> Tuple[HashMapState, torch.Tensor]:
    """Insert (or find) a batch of cells (M, 3) where ``want`` (M,).
    Returns (state', table_pos (M,) int64, -1 where dropped)."""
    m, T, dev = cells.shape[0], cfg.table_size, cells.device
    h = _hash(cfg, cells)
    rank = torch.arange(m, device=dev)
    keys = state.keys
    table_pos = torch.full((m,), -1, dtype=torch.int64, device=dev)
    pending = want
    for r in range(cfg.n_probes):
        p = (h + r) & (T - 1)
        empty = keys[p][:, 0] == EMPTY
        # claim empty entries: the lowest rank wins
        claim = torch.where(pending & empty, rank, m)
        winner = torch.full((T,), m, dtype=torch.int64, device=dev).scatter_reduce(
            0, p, claim, "amin")
        won = pending & empty & (winner[p] == rank)
        keys = M.scatter_drop(keys, torch.where(won, p, T), cells)
        # re-read: own wins, a duplicate cell's win and old entries resolve
        match = torch.all(keys[p] == cells, dim=-1)
        table_pos = torch.where(pending & match, p, table_pos)
        pending = pending & ~match

    # latent slots for the entries claimed just now, in table order
    is_new = (keys[:, 0] != EMPTY) & (state.table_slot < 0)
    order = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32)
    slot = state.n_occupied + order - 1
    ok = is_new & (slot < cfg.capacity)
    table_slot = torch.where(ok, slot, state.table_slot)
    slot_cell = M.scatter_drop(state.slot_cell,
                               torch.where(ok, slot, cfg.capacity).to(torch.int64), keys)
    n_new = order[-1]
    n_occupied = torch.clamp(state.n_occupied + n_new, max=cfg.capacity)
    overflow = (state.overflow + (pending & want).sum().to(torch.int32)
                + torch.clamp(state.n_occupied + n_new - cfg.capacity, min=0))
    return state._replace(keys=keys, table_slot=table_slot, slot_cell=slot_cell,
                          n_occupied=n_occupied, overflow=overflow), table_pos


def slot_of(cfg: HashMapConfig, state: HashMapState, cells: torch.Tensor) -> torch.Tensor:
    """cells (..., 3) -> int64 latent slot or -1."""
    pos = lookup(cfg, state.keys, cells)
    return torch.where(pos >= 0, state.table_slot[torch.clamp(pos, min=0)].to(torch.int64),
                       -1)


def _elig(cfg: HashMapConfig, state: HashMapState, slot: torch.Tensor) -> torch.Tensor:
    """Allocated and not yet converged (encoder-eligible)."""
    return (slot >= 0) & (state.obs_count[torch.clamp(slot, 0, cfg.capacity - 1)]
                          < cfg.encoder_count_th)


def _cell_counts(cell: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N,) the number of valid points in each point's cell.  Stable sorts
    by z, y, x make equal cells contiguous (the JAX package's ``lexsort`` on
    (hash, cell) orders them otherwise; only the grouping matters)."""
    n = cell.shape[0]
    order = torch.arange(n, device=cell.device)
    for axis in (2, 1, 0):
        order = order[torch.sort(cell[order, axis], stable=True).indices]
    c_s = cell[order]
    same = torch.all(c_s[1:] == c_s[:-1], dim=1)
    seg = torch.cumsum(torch.cat([same.new_zeros(1), ~same]).to(torch.int64), 0)
    seg_cnt = torch.zeros(n, dtype=torch.int32, device=cell.device).index_add_(
        0, seg, valid[order].to(torch.int32))
    return torch.empty_like(seg_cnt).index_copy_(0, order, seg_cnt[seg])


def integrate_keyframe(cfg: HashMapConfig, encoder: Encoder, state: HashMapState,
                       surface_xyz: torch.Tensor, surface_normal: torch.Tensor,
                       valid: torch.Tensor) -> HashMapState:
    """Hash-map counterpart of the dense ``integrate_keyframe``: per-cell
    observation pruning, allocation of the surviving cells and their
    6-neighbourhood, the focus-pruned 8-voxel encoding and the running-mean
    fusion.  Returns a new state; the input state is not modified."""
    dev = surface_xyz.device
    n = surface_xyz.shape[0]
    pn = surface_xyz * recip(cfg.voxel_size)
    cell = cell_of(cfg, surface_xyz)

    # 1. prune sparsely observed cells (counted before allocation)
    keep = valid & (_cell_counts(cell, valid) > cfg.prune_min_vox_obs)

    # 2. allocate the surviving cells and their 6-neighbourhood
    nb_cells = (cell[:, None, :] + const(_NEIGHBORS7, dev, torch.int64)[None]).reshape(-1, 3)
    state, nb_pos = insert(cfg, state, nb_cells, keep[:, None].expand(n, 7).reshape(-1))
    nb_pos = nb_pos.reshape(n, 7)

    # 3. focus: a point's cell lies in the 6-dilation of the eligible set
    nb_slot = torch.where(nb_pos >= 0,
                          state.table_slot[torch.clamp(nb_pos, min=0)].to(torch.int64), -1)
    focus = keep & torch.any(_elig(cfg, state, nb_slot), dim=1)

    # 4. the 8 voxels around every point
    ng = torch.ceil(pn[:, None, :] + const(M._INTEGRATION_OFFSETS, dev)[None]) - 1
    rel = pn[:, None, :] - ng - 0.5
    ng_slot = slot_of(cfg, state, ng.to(torch.int64))                 # (N, 8)
    contrib = focus[:, None] & _elig(cfg, state, ng_slot)
    seg = torch.where(contrib, ng_slot, cfg.capacity).reshape(-1)

    xyzn = torch.cat([rel, surface_normal[:, None, :].expand(-1, 8, -1)],
                     dim=-1).reshape(n * 8, 6)
    codes = encoder.encode_points(xyzn)
    w = contrib.reshape(-1).to(codes.dtype)
    sums = M._segment_sum(cfg.capacity + 1, seg, codes * w[:, None])[:-1]
    cnts = M._segment_sum(cfg.capacity + 1, seg, w)[:-1]

    # 5. weighted running-mean fusion
    new_count = state.obs_count + cnts
    fused = ((sums + state.latents * state.obs_count[:, None])
             / torch.clamp(new_count, min=1e-12)[:, None])
    touched = cnts > 0
    latents = torch.where(touched[:, None], fused, state.latents)
    return state._replace(latents=latents, obs_count=new_count,
                          mesh_dirty=state.mesh_dirty | touched)


def gather_latent_rel(cfg: HashMapConfig, state: HashMapState, xyz: torch.Tensor,
                      aug_table: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe + latent gather + voxel-local coordinates of world points; the
    dense :func:`~.map.gather_latent_rel`'s contract (``d rel / d xyz = 1 /
    voxel_size``).  The reference takes the cell of ``pn * voxel_size``;
    under ``jit`` XLA folds ``pn * voxel_size / voxel_size`` to ``pn``, so
    the cell is ``ceil(pn) - 1``."""
    pn = xyz * recip(cfg.voxel_size)
    cell = torch.ceil(pn).to(torch.int64) - 1
    slot = slot_of(cfg, state, cell)
    row = aug_table[torch.clamp(slot, 0, cfg.capacity - 1)]
    valid = (slot >= 0) & (row[:, -1] > cfg.ignore_count_th)
    latent = torch.where(valid[:, None], row[:, :-1],
                         torch.zeros((), dtype=row.dtype, device=row.device))
    return latent, pn - cell.to(pn.dtype) - 0.5, valid


def query_sdf(cfg: HashMapConfig, decoder: Decoder, state: HashMapState,
              xyz: torch.Tensor, compute_dtype: torch.dtype = torch.float32
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sdf, std, valid) of world points through the decoder (in
    ``compute_dtype``)."""
    latent, rel, valid = gather_latent_rel(cfg, state, xyz, M.latent_count_table(state))
    sdf, std = decoder.decode(latent, rel, compute_dtype=compute_dtype)
    return sdf, std, valid


def build_optimize_samples(cfg: HashMapConfig, state: HashMapState,
                           surface_xyz: torch.Tensor, surface_normal: torch.Tensor,
                           valid: torch.Tensor, noise: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense :func:`~.map.build_optimize_samples` on the hash map: each
    point's 8 voxels resolve through :func:`slot_of`, and a sample counts
    where its voxel is converged and not yet optimized."""
    dev = surface_xyz.device
    pn = surface_xyz * recip(cfg.voxel_size)
    ng = torch.ceil(pn[:, None, :] + const(M._INTEGRATION_OFFSETS, dev)[None]) - 1
    rel = pn[:, None, :] - ng - 0.5
    slot = slot_of(cfg, state, ng.to(torch.int64))                    # (N, 8)
    slot_safe = torch.clamp(slot, 0, cfg.capacity - 1)
    optim = ((slot >= 0) & (state.obs_count[slot_safe] >= cfg.encoder_count_th)
             & ~state.optimized[slot_safe])
    return M.noisy_samples(valid[:, None] & optim, slot, rel, surface_normal, noise,
                           cfg.capacity)


# the Adam loop and the merge work in slot space only: the dense map's serve
optimize_latents = M.optimize_latents
merge_optimize_result = M.merge_optimize_result


_FLOAT_FIELDS = ("voxel_size", "ignore_count_th", "encoder_count_th")


def save_map(path, cfg: HashMapConfig, state: HashMapState) -> None:
    """Write the map as the JAX package's hash ``save_map`` does."""
    arrays = {f"state.{k}": getattr(state, k).cpu().numpy() for k in HashMapState._fields}
    arrays.update({f"cfg.{k}": np.asarray(getattr(cfg, k)) for k in HashMapConfig._fields})
    np.savez_compressed(path, **arrays)


def load_map(path, device="cuda") -> Tuple[HashMapConfig, HashMapState]:
    """Read a hash-map npz written by either package onto ``device``."""
    dev = resolve_device(device)
    with np.load(path) as data:
        cfg = HashMapConfig(**{k: (float if k in _FLOAT_FIELDS else int)(data[f"cfg.{k}"])
                               for k in HashMapConfig._fields})
        state = HashMapState(**{k: torch.from_numpy(a).to(dev) for k, a in
                                M.state_arrays(data, HashMapState._fields,
                                               cfg.capacity).items()})
    return cfg, state
