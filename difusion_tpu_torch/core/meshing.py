"""Incremental mesh extraction (counterpart of difusion_tpu/core/meshing.py:
``_mesh_prep_dense``, ``_mesh_prep_hash``, ``_batch_tables``,
``_build_subgrid``, ``_eval_and_negate``, ``_align_corners_matrix``,
``_eval_and_negate_fast``, ``_MeshExtractorBase``,
``MeshExtractor`` and ``HashMeshExtractor``; the JAX module's
``_dilate6_cells`` serves its tests only, and the port's tests use it).

Two backends share the driver: :class:`MeshExtractor` for the dense map,
whose own indexer is the marching-cubes grid, and :class:`HashMeshExtractor`
for the hash-indexed map, which scatters the extract's (cell, slot) rows
into a dense sub-grid over their bounding box on the device (only the
12-byte origin crosses to the card).

Per extract:

1. On the device, the slots in the 6-neighbourhood of a dirty slot that
   clear the confidence threshold compact to the front with
   ``torch.nonzero`` -- the extract's one count sync -- and their n
   (cell, slot) rows download in one transfer.
2. Each of the n live blocks' (2r)^3 lattices is decoded in dispatches of
   C blocks (a power of two, at most ``max_eval_points`` sites), the last
   one holding the blocks that are left, with latents gathered on the
   device.  Only the batch tables and the marching-cubes block list pad to
   a power-of-two bucket B (one upload of 4 B bytes); no padding block is
   decoded.  The production decoder goes through kernel 3
   (``ops.decoder_fused.decode_fused``: the CUDA kernel on the card, its
   plain version on the CPU); any other decoder through ``Decoder.decode``.
   With ``fast`` the decode is coarse-to-fine: the r^3 lattice, trilinear
   upsampling to (2r)^3, and an exact decode of each block's ``refine_k``
   sites nearest the surface -- two decodes a dispatch.
3. Sparse marching cubes runs in chunks of the n live blocks against the
   full lattice buffers, so chunk seams are exact (``ops.marching_cubes``:
   three CUDA kernel launches a chunk on the card, its plain version on the
   CPU).  Every chunk writes its rows and its count into one device buffer;
   the host reads nothing in the loop.
4. ``ops.marching_cubes.mc_splice`` gathers every chunk's kept rows in
   chunk order into world-space vertices, stds and slots (one kernel launch
   on the card, its plain version on the CPU); the host reads the count and
   downloads each output once (``last_stats["host_reads"]``), and the
   triangles splice into a host-side cache keyed by latent slot: a
   re-meshed slot's old triangles are replaced.

With ``shard`` (the JAX package's ``shard``, ``mesh_tool --shard``) each
decode dispatch whose block count divides by the number of devices splits into
contiguous block slices, one a device (every visible card by default, as
``jax.devices()``): each slice decodes on its device (kernel 3 for the
production decoder; blocks are independent, so the values are the
unsharded decode's) against that device's copy of the packed weights and
the latent table, made once an extract, and the slices come back to the
map's device before marching cubes.  With one device the extract is the
unsharded one.

Spans (:mod:`..utils.tracing`), one set for both backends: ``mesh.extract``
(its item the extractor's extract number) holds ``mesh.prep`` (1; its count
read and its download are the device waits ``mesh.prep.sync``),
``mesh.grid`` (the batch tables, the backend's grid and the blocks' upload),
``mesh.cond`` (a conditioned decoder's conditioning of the live blocks,
once an extract), ``mesh.decode`` (the decode dispatches), ``mesh.mc`` a chunk (3)
and ``mesh.splice`` (4; its count read and downloads, ``mesh.splice.download``,
a device wait).
"""
from __future__ import annotations

import copy
import logging
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import const
from ..models.decoder import Decoder
from ..ops import decoder_fused as _fused
from ..ops.marching_cubes import ROW, marching_cubes_sparse, mc_splice, mc_triangles_np
from ..ops.sampling import block_lattice, get_samples
from ..utils import tracing
from . import hash_map as HM
from . import map as M

_NEIGHBORS7 = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0),
               (0, -1, 0), (0, 0, 1), (0, 0, -1))


def _mesh_prep_dense(cfg: M.MapConfig, state: M.MapState, no_cache: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-side dirty-block resolution.  A slot participates iff its cell
    lies in the 6-neighbourhood of a dirty cell (equivalently: one of its 7
    face neighbours, itself included, maps to a dirty slot) and it clears
    the confidence threshold.  Returns (cells (n, 3), slots (n,)) int64,
    slots ascending."""
    dev = state.indexer.device
    dirty = (state.obs_count > 0.0) if no_cache else state.mesh_dirty
    cell = M.unlinearize(cfg, torch.clamp(state.positions, min=0).to(torch.int64))
    flag = torch.zeros(cfg.capacity, dtype=torch.bool, device=dev)
    for off in _NEIGHBORS7:
        nb = cell + const(off, dev, torch.int64)
        inb = M.in_bounds(cfg, nb)
        nb_slot = state.indexer[torch.clamp(M.linearize(cfg, nb), 0, cfg.n_cells - 1)]
        nb_dirty = (nb_slot >= 0) & dirty[
            torch.clamp(nb_slot, 0, cfg.capacity - 1).to(torch.int64)]
        flag = flag | (inb & nb_dirty)
    flag = flag & (state.positions >= 0) & (state.obs_count > cfg.ignore_count_th)
    s = tracing.begin("mesh.prep.sync", wait=True) if tracing.ON else -1
    slots = torch.nonzero(flag)[:, 0]                  # the one count sync
    if s >= 0:
        tracing.end(s)
    return cell[slots], slots


def _mesh_prep_hash(cfg: HM.HashMapConfig, state: HM.HashMapState, no_cache: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_mesh_prep_dense` for the hash map: the 7 neighbour probes go
    through the hash table.  Returns (cells (n, 3), slots (n,)) int64,
    slots ascending."""
    dev = state.obs_count.device
    dirty = (state.obs_count > 0.0) if no_cache else state.mesh_dirty
    occupied = torch.arange(cfg.capacity, device=dev) < state.n_occupied
    cell = state.slot_cell.to(torch.int64)
    flag = torch.zeros(cfg.capacity, dtype=torch.bool, device=dev)
    for off in _NEIGHBORS7:
        nb_slot = HM.slot_of(cfg, state, cell + const(off, dev, torch.int64))
        flag = flag | ((nb_slot >= 0)
                       & dirty[torch.clamp(nb_slot, 0, cfg.capacity - 1)])
    flag = flag & occupied & (state.obs_count > cfg.ignore_count_th)
    s = tracing.begin("mesh.prep.sync", wait=True) if tracing.ON else -1
    slots = torch.nonzero(flag)[:, 0]                  # the one count sync
    if s >= 0:
        tracing.end(s)
    return cell[slots], slots


def _build_subgrid(cells: torch.Tensor, slots: torch.Tensor, lo: torch.Tensor,
                   n_xyz: Tuple[int, int, int]) -> torch.Tensor:
    """The live (cell, slot) rows scattered into a dense (-1 filled)
    sub-grid with origin ``lo``, on the device: the hash backend's
    marching-cubes indexer."""
    local = cells - lo[None, :]
    lin = local[:, 0] * (n_xyz[1] * n_xyz[2]) + local[:, 1] * n_xyz[2] + local[:, 2]
    grid = torch.full((int(np.prod(n_xyz)),), -1, dtype=torch.int32, device=cells.device)
    grid[lin] = slots.to(torch.int32)
    return grid


def _batch_tables(slots: torch.Tensor, B: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``slot_pad`` (B,): the slot list padded with slot 0; ``slot_to_batch``
    (capacity + 1,): each live slot's batch row, -1 elsewhere (the last
    entry stays -1 for free slots)."""
    n, dev = slots.shape[0], slots.device
    slot_pad = torch.zeros(B, dtype=torch.int64, device=dev)
    slot_pad[:n] = slots
    slot_to_batch = torch.full((capacity + 1,), -1, dtype=torch.int64, device=dev)
    slot_to_batch[slots] = torch.arange(n, device=dev)
    return slot_pad, slot_to_batch


@lru_cache(maxsize=16)
def _lattice(r: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(block_lattice(r)).to(device)


def _per_site(latents: torch.Tensor, k: int) -> torch.Tensor:
    """(C, L) -> (C*k, L), each block's latent once a site, contiguous as
    the kernel takes it (for one block the expanded reshape is only a view
    with a zero stride)."""
    C, L = latents.shape
    return latents[:, None, :].expand(C, k, L).reshape(C * k, L).contiguous()


def _decode_lattice(decoder: Decoder, packed: Optional[torch.Tensor],
                    lat: torch.Tensor, xyz: torch.Tensor):
    """Forward-only decode: kernel 3 for the production decoder (``packed``
    given), ``Decoder.decode`` for a decoder the kernel does not support."""
    if packed is not None:
        return _fused.decode_fused(packed, lat, xyz)
    return decoder.decode(lat, xyz)


def _eval_and_negate_cond(pack: "_fused.CondPack", cond: torch.Tensor,
                          blocks: torch.Tensor, r: int):
    """:func:`_eval_and_negate` for a decoder conditioned once a code:
    ``cond`` holds the extract's live blocks' conditioning, ``blocks`` (C,)
    int32 the rows of this dispatch's blocks, each of whose (2r)^3 sites
    reads its block's row (kernel 3's onet_cbn or pigan_film instance)."""
    C = blocks.shape[0]
    lattice = _lattice(r, cond.device)                  # (K, 3)
    K = lattice.shape[0]
    idx = blocks[:, None].expand(C, K).reshape(C * K).contiguous()
    xyz = lattice[None].expand(C, K, 3).reshape(C * K, 3)
    sdf, std = _fused.decode_fwd_cond(pack, cond, idx, xyz)
    side = 2 * r
    return (-sdf).reshape(C, side, side, side), std.reshape(C, side, side, side)


def _eval_and_negate(decoder: Decoder, packed: Optional[torch.Tensor],
                     table: torch.Tensor, slot_chunk: torch.Tensor, r: int):
    """Decode the (2r)^3 lattice of each block in ``slot_chunk`` (latents
    gathered from the full ``table``) and negate the sdf (the MC
    inside/outside convention).  The per-site inputs are materialised as
    contiguous (C*K, 29) and (C*K, 3) tensors, as the kernel takes them."""
    latents = table[slot_chunk]
    C = latents.shape[0]
    lattice = _lattice(r, table.device)                 # (K, 3)
    K = lattice.shape[0]
    lat = _per_site(latents, K)
    xyz = lattice[None].expand(C, K, 3).reshape(C * K, 3)
    sdf, std = _decode_lattice(decoder, packed, lat, xyz)
    side = 2 * r
    return (-sdf).reshape(C, side, side, side), std.reshape(C, side, side, side)


@lru_cache(maxsize=16)
def _coarse_lattice(r: int, device: torch.device) -> torch.Tensor:
    """The r^3 lattice over the (2r)^3 lattice's extent."""
    a, b = -(r // 2) * (1.0 / r), 1.0 + ((r - 1) // 2) * (1.0 / r)
    return torch.from_numpy(get_samples(r, a=a, b=b) - np.float32(0.5)).to(device)


def _align_corners_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) f32 1-D linear interpolation with align_corners=True
    endpoints; applied along each axis it is trilinear upsampling."""
    t = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    j0 = np.minimum(t.astype(np.int64), n_in - 2)
    w = t - j0
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), j0] = 1.0 - w
    m[np.arange(n_out), j0 + 1] = w
    return m


@lru_cache(maxsize=16)
def _upsample_matrix(r: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_align_corners_matrix(2 * r, r)).to(device)


def _coarse_to_fine(decoder: Decoder, packed: Optional[torch.Tensor],
                    latents: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode each block's r^3 lattice and upsample it trilinearly to
    (2r)^3 (three contractions with the align-corners matrix): (C, (2r)^3)
    sdf and std."""
    C = latents.shape[0]
    K = r ** 3
    coarse = _coarse_lattice(r, latents.device)
    sdf_c, std_c = _decode_lattice(decoder, packed,
                                   _per_site(latents, K),
                                   coarse[None].expand(C, K, 3).reshape(C * K, 3))
    m = _upsample_matrix(r, latents.device)

    def up(vol):
        vol = torch.einsum("xa,Bayz->Bxyz", m, vol.reshape(C, r, r, r))
        vol = torch.einsum("yb,Bxbz->Bxyz", m, vol)
        return torch.einsum("zc,Bxyc->Bxyz", m, vol).reshape(C, (2 * r) ** 3)
    return up(sdf_c), up(std_c)


def _refine_sites(sdf_f: torch.Tensor, refine_k: int) -> torch.Tensor:
    """(C, refine_k) the sites of each row with the smallest |sdf|, in
    ``jax.lax.top_k(-|sdf|, refine_k)``'s order: a stable sort, so among
    equal values the lower index comes first."""
    return torch.sort(sdf_f.abs(), dim=1, stable=True).indices[:, :refine_k]


def _eval_and_negate_fast(decoder: Decoder, packed: Optional[torch.Tensor],
                          table: torch.Tensor, slot_chunk: torch.Tensor, r: int,
                          refine_k: int):
    """:func:`_eval_and_negate` coarse-to-fine (:func:`_coarse_to_fine`),
    then the ``refine_k`` sites of each block nearest the surface
    (:func:`_refine_sites`) decoded exactly over the interpolation.  Decoder
    evaluations a block: r^3 + refine_k against (2r)^3."""
    latents = table[slot_chunk]
    C = latents.shape[0]
    side = 2 * r
    sdf_f, std_f = _coarse_to_fine(decoder, packed, latents, r)
    idx = _refine_sites(sdf_f, refine_k)
    sdf_r, std_r = _decode_lattice(
        decoder, packed, _per_site(latents, refine_k),
        _lattice(r, table.device)[idx.reshape(-1)])
    sdf_f = sdf_f.scatter(1, idx, sdf_r.reshape(C, refine_k))
    std_f = std_f.scatter(1, idx, std_r.reshape(C, refine_k))
    return (-sdf_f).reshape(C, side, side, side), std_f.reshape(C, side, side, side)


def _next_bucket(n: int, minimum: int = 64) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _jet_lut() -> np.ndarray:
    """(256, 3) float64: matplotlib's ``cm.jet`` lookup table, rebuilt from
    its segment data as ``LinearSegmentedColormap`` builds it (the machine
    with the card has no matplotlib)."""
    segments = {
        "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
        "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
                  (0.91, 0, 0), (1.0, 0, 0)),
        "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
    }
    n = 256
    xind = (n - 1) * np.linspace(0, 1, n)
    out = []
    for name in ("red", "green", "blue"):
        data = np.array(segments[name])
        x, y0, y1 = data[:, 0] * (n - 1), data[:, 1], data[:, 2]
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                              [y0[-1]]])
        out.append(np.clip(lut, 0.0, 1.0))
    return np.stack(out, axis=1)


_JET = _jet_lut()


def jet_rgb(t: np.ndarray) -> np.ndarray:
    """Values in [0, 1] -> (N, 3) uint8 jet colours, as
    ``(matplotlib.cm.jet(t)[:, :3] * 255).astype(np.uint8)`` gives them
    (entry min(int(256 t), 255), ``256 t`` in ``t``'s own dtype)."""
    idx = np.minimum((np.asarray(t) * 256).astype(np.int64), 255)
    return (_JET[idx] * 255).astype(np.uint8)


def _shard_devices(dev: torch.device) -> list:
    """The devices a sharded decode chunk of a map on ``dev`` splits over:
    every visible card for a map on the card, as ``jax.devices()``, else
    ``dev`` alone.  The list may name a device more than once; the tests
    and ``chip_smoke.py`` patch this function to split a chunk on one
    device."""
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


class _MeshExtractorBase:
    """The cache and the extract driver; a backend resolves cells and slots
    (:meth:`_mesh_prep`) and gives the marching-cubes grid (:meth:`_mc_grid`).

    ``max_eval_points`` bounds the lattice sites a decode dispatch and (over
    4) the candidate cubes a marching-cubes chunk, so a full ``no_cache``
    extract of a large map runs in bounded memory.  ``fast`` decodes
    coarse-to-fine (:func:`_eval_and_negate_fast`) with ``refine_k =
    max(int(refine_fraction * (2r)^3), 8)`` exact sites a block.

    ``shard`` spreads each decode chunk over the devices
    :func:`_shard_devices` names: see the module docstring."""

    def __init__(self, decoder: Decoder, voxel_resolution: int = 4,
                 max_triangles: int = 1 << 20, interpolate: bool = True,
                 fast: bool = False, refine_fraction: float = 0.2,
                 max_eval_points: int = 1 << 20, shard: bool = False):
        self.decoder = decoder
        self.packed = (_fused.pack_fused_decoder(decoder)
                       if _fused.supports_spec(decoder.spec,
                                               decoder.uncertainty.weight.device) else None)
        if isinstance(self.packed, _fused.CondPack) and fast:
            raise NotImplementedError("the coarse-to-fine mesher (fast) is not written for "
                                      f"{decoder.spec.NAME} decoders")
        self.r = int(voxel_resolution)
        self.max_triangles = int(max_triangles)
        self.interpolate = interpolate
        self.fast = fast
        self.refine_k = max(int(refine_fraction * (2 * self.r) ** 3), 8)
        self.max_eval_points = int(max_eval_points)
        self.shard = bool(shard)
        # host<->device traffic of the last extract, excluding the triangle
        # output itself; and its sizes (blocks, bucket, decoded blocks, dispatches)
        self.last_transfer_bytes = 0
        self.last_stats: dict = {}
        self._n_extracts = 0                  # the mesh.extract spans' item
        self.cond_rows = 0                    # blocks conditioned (CondPack)
        self.clear_cache()

    # -- cache ---------------------------------------------------------------
    def clear_cache(self):
        self._tris = np.zeros((0, 3, 3), np.float32)
        self._std = np.zeros((0, 3), np.float32)
        self._slot = np.zeros((0,), np.int64)

    def triangles(self) -> Tuple[np.ndarray, np.ndarray]:
        """Triangle soup: (T, 3, 3) world-space vertices, (T, 3) stds."""
        return self._tris, self._std

    def vertices_faces(self) -> Tuple[np.ndarray, np.ndarray]:
        verts = self._tris.reshape(-1, 3)
        faces = np.arange(verts.shape[0]).reshape(-1, 3)
        return verts, faces

    # -- backend hooks ---------------------------------------------------------
    def _mesh_prep(self, state, no_cache: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (cells (n, 3), slots (n,)) of the blocks to mesh, on the device."""
        raise NotImplementedError

    def _mc_grid(self, state, cells: np.ndarray, cells_d: torch.Tensor,
                 slots_d: torch.Tensor):
        """-> (indexer (n_local,) device int32, n_xyz_local, origin (3,)
        int64, upload bytes).  ``cells`` is the host copy of the rows (for
        the bounding box), ``cells_d``/``slots_d`` the device ones."""
        raise NotImplementedError

    # -- extraction ----------------------------------------------------------
    def extract(self, state, max_std: float = 2000.0, no_cache: bool = False):
        """Re-mesh the blocks around dirty slots (every observed block with
        ``no_cache``) and return the state with its dirty flags cleared."""
        se = tracing.begin("mesh.extract", self._n_extracts) if tracing.ON else -1
        self._n_extracts += 1
        state = self._extract(state, max_std, no_cache)
        if se >= 0:
            tracing.end(se)
        return state

    def _extract(self, state, max_std: float, no_cache: bool):
        if no_cache:
            self.clear_cache()
        capacity = state.latents.shape[0]
        s = tracing.begin("mesh.prep") if tracing.ON else -1
        cells_d, slots_d = self._mesh_prep(state, no_cache)
        state = state._replace(mesh_dirty=torch.zeros_like(state.mesh_dirty))
        n = slots_d.shape[0]
        self.last_transfer_bytes = 4
        self.last_stats = {"blocks": n}
        if n == 0:
            if s >= 0:
                tracing.end(s)
            return state
        # the only state->host transfer: the n live (cell, slot) rows
        sw = tracing.begin("mesh.prep.sync", wait=True) if tracing.ON else -1
        rows = torch.cat([cells_d, slots_d[:, None]], dim=1).cpu().numpy()
        if sw >= 0:
            tracing.end(sw)
        cells, slots = rows[:, :3], rows[:, 3]
        self.last_transfer_bytes += n * 12 + n * 4
        if s >= 0:
            tracing.end(s)

        s = tracing.begin("mesh.grid") if tracing.ON else -1
        dev = state.latents.device
        B = _next_bucket(n)
        slot_pad_d, slot_to_batch_d = _batch_tables(slots_d, B, capacity)
        indexer_d, n_xyz_local, origin, up_bytes = self._mc_grid(state, cells, cells_d,
                                                                 slots_d)
        self.last_transfer_bytes += up_bytes
        nxl, nyl, nzl = (int(v) for v in n_xyz_local)
        local = cells - origin[None, :]
        lin_local = (local[:, 0] * nyl * nzl + local[:, 1] * nzl
                     + local[:, 2]).astype(np.int32)
        valid_blocks = np.full(B, -1, np.int32)
        valid_blocks[:n] = lin_local
        # one upload for every marching-cubes chunk, before the decode: a
        # pageable copy waits for the card's queue to drain
        valid_blocks_d = torch.from_numpy(valid_blocks).to(dev)
        self.last_transfer_bytes += B * 4
        if s >= 0:
            tracing.end(s)

        # decoder evaluation of the n live blocks in dispatches of C blocks
        # (<= max_eval_points lattice sites), the last one ragged; with shard,
        # each dispatch in contiguous block slices over the devices (as the
        # JAX package, only when they divide its block count), which get
        # their copies of the weights and the latent table once an extract
        per_block = (2 * self.r) ** 3
        C = min(_next_bucket(max(self.max_eval_points // per_block, 1)), B)
        starts = range(0, n, C)
        shards = _shard_devices(dev) if self.shard else []
        split = [len(shards) >= 2 and min(C, n - s0) % len(shards) == 0 for s0 in starts]
        # what a dispatch's blocks read: the latent table by slot, or (a
        # conditioned family) the live blocks' conditioning, made once an
        # extract, by block
        conditioned = isinstance(self.packed, _fused.CondPack)
        table, order = state.latents, slot_pad_d
        if conditioned:
            s = tracing.begin("mesh.cond") if tracing.ON else -1
            table = _fused.condition(self.packed, state.latents[slots_d.long()].contiguous())
            order = torch.arange(n, dtype=torch.int32, device=dev)
            self.cond_rows += n
            if s >= 0:
                tracing.end(s)
        copies = {d: (self.decoder if d == dev else copy.deepcopy(self.decoder).to(d),
                      None if self.packed is None else self.packed.to(d),
                      table.to(d)) for d in (set(shards) if any(split) else ())}

        s = tracing.begin("mesh.decode") if tracing.ON else -1

        def decode(decoder, packed, table, chunk):
            if conditioned:
                return _eval_and_negate_cond(packed, table, chunk, self.r)
            if self.fast:
                return _eval_and_negate_fast(decoder, packed, table, chunk, self.r,
                                             self.refine_k)
            return _eval_and_negate(decoder, packed, table, chunk, self.r)
        parts = []
        for s0, sliced in zip(starts, split):
            chunk = order[s0:min(s0 + C, n)]
            if not sliced:
                parts.append(decode(self.decoder, self.packed, table, chunk))
                continue
            k = chunk.shape[0] // len(shards)
            pieces = [decode(*copies[d], chunk[j * k:(j + 1) * k].to(d))
                      for j, d in enumerate(shards)]
            parts.append(tuple(torch.cat([q[i].to(dev) for q in pieces]) for i in (0, 1)))
        evals_per_block = self.r ** 3 + self.refine_k if self.fast else per_block
        cube_sdf = torch.cat([p[0] for p in parts])
        cube_std = torch.cat([p[1] for p in parts])
        if s >= 0:
            tracing.end(s)

        # marching cubes over chunks of the live blocks; each chunk's corner
        # blending reads ANY evaluated neighbour through slot_to_batch.  Every
        # chunk's rows and count stay on the device for the splice.
        n_sub = self.r ** 3
        C_mc = min(_next_bucket(max(self.max_eval_points // (4 * n_sub), 64)), B)
        n_chunks = -(-n // C_mc)
        budget = min(self.max_triangles, 5 * n_sub * C_mc)
        self.last_stats.update(bucket=B, sites_per_dispatch=C * per_block,
                               decode_instance=_fused.instance_name(
                                   self.packed, state.latents.shape[1], dev),
                               decoded_blocks=cube_sdf.shape[0],
                               conditioned_blocks=n if conditioned else 0,
                               decode_dispatches=len(starts),
                               decode_devices=len(shards) if any(split) else 1,
                               mc_chunks=n_chunks,
                               decoder_evals=n * evals_per_block)
        packed = torch.empty(n_chunks, budget, ROW, device=dev)
        counts = torch.empty(n_chunks, dtype=torch.int64, device=dev)
        for k in range(n_chunks):
            s = tracing.begin("mesh.mc") if tracing.ON else -1
            s0 = k * C_mc
            marching_cubes_sparse(
                indexer_d, slot_to_batch_d, valid_blocks_d[s0:min(s0 + C_mc, n)], cube_sdf,
                cube_std, (nxl, nyl, nzl), self.r, budget, max_std=max_std,
                interpolate=self.interpolate, out=(packed[k], counts[k]))
            if s >= 0:
                tracing.end(s)
        s = tracing.begin("mesh.splice") if tracing.ON else -1
        # the block -> slot table, on the device from what is there
        table = torch.full((nxl * nyl * nzl,), -1, dtype=torch.int64, device=dev)
        table[valid_blocks_d[:n].long()] = slots_d
        spliced = mc_splice(packed, counts, table, origin, self.voxel_size, self.world_origin,
                            self.max_triangles)
        # the extract's one count read and one download of each output
        sw = tracing.begin("mesh.splice.download", wait=True) if tracing.ON else -1
        tris, stds, tri_slot, emitted = mc_triangles_np(spliced)
        if sw >= 0:
            tracing.end(sw)
        self.last_stats["host_reads"] = 1
        if emitted > self.max_triangles:
            logging.warning("marching cubes: triangle budget too small (%d > %d)",
                            emitted, self.max_triangles)

        # the cache: a re-meshed slot's old triangles go; with nothing kept
        # the new arrays become the cache as they are
        if len(self._slot):
            remeshed = np.zeros(capacity, bool)
            remeshed[slots] = True
            keep_mask = ~remeshed[self._slot]
            if keep_mask.any():
                tris = np.concatenate([self._tris[keep_mask], tris])
                stds = np.concatenate([self._std[keep_mask], stds])
                tri_slot = np.concatenate([self._slot[keep_mask], tri_slot])
        self._tris, self._std, self._slot = tris, stds, tri_slot
        if s >= 0:
            tracing.end(s)
        return state

    # -- export --------------------------------------------------------------
    def write_obj(self, path: str):
        verts, faces = self.vertices_faces()
        with open(path, "w") as f:
            for v in verts:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for face in faces + 1:
                f.write(f"f {face[0]} {face[1]} {face[2]}\n")

    def write_ply(self, path: str, std_range: Optional[Tuple[float, float]] = None):
        """Binary PLY with per-vertex uncertainty colour (jet colormap, as
        matplotlib's ``cm.jet`` quantises it: entry min(int(256 t), 255))."""
        verts, faces = self.vertices_faces()
        stds = self._std.reshape(-1)
        if len(stds):
            lo, hi = std_range if std_range is not None else (stds.min(), stds.max())
            colors = jet_rgb(np.clip((stds - lo) / max(hi - lo, 1e-12), 0.0, 1.0))
        else:
            colors = np.zeros((0, 3), np.uint8)
        vrec = np.empty(len(verts), np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)]))
        vrec["xyz"] = verts
        vrec["rgb"] = colors
        frec = np.empty(len(faces), np.dtype([("n", "u1"), ("idx", "<i4", 3)]))
        frec["n"] = 3
        frec["idx"] = faces
        with open(path, "wb") as f:
            f.write((
                "ply\nformat binary_little_endian 1.0\n"
                f"element vertex {len(verts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                f"element face {len(faces)}\n"
                "property list uchar int vertex_indices\nend_header\n").encode())
            f.write(vrec.tobytes())
            f.write(frec.tobytes())


class MeshExtractor(_MeshExtractorBase):
    """Dense-map backend: the map's own indexer is the marching-cubes grid
    (nothing uploads)."""

    def __init__(self, cfg: M.MapConfig, decoder: Decoder, **kw):
        super().__init__(decoder, **kw)
        self.cfg = cfg
        self.voxel_size = cfg.voxel_size
        self.world_origin = np.asarray(cfg.bound_min, np.float32)

    def _mesh_prep(self, state, no_cache):
        return _mesh_prep_dense(self.cfg, state, no_cache)

    def _mc_grid(self, state, cells, cells_d, slots_d):
        return state.indexer, self.cfg.n_xyz, np.zeros(3, np.int64), 0


class HashMeshExtractor(_MeshExtractorBase):
    """Hash-map backend: a dense sub-grid over the bounding box of the
    extract's cells (one cell of margin; dims padded to multiples of 16),
    scattered on the device."""

    def __init__(self, cfg: HM.HashMapConfig, decoder: Decoder, **kw):
        super().__init__(decoder, **kw)
        self.cfg = cfg
        self.voxel_size = cfg.voxel_size
        self.world_origin = np.zeros(3, np.float32)

    def _mesh_prep(self, state, no_cache):
        return _mesh_prep_hash(self.cfg, state, no_cache)

    def _mc_grid(self, state, cells, cells_d, slots_d):
        lo = cells.min(axis=0) - 1
        span = cells.max(axis=0) + 2 - lo
        n_xyz = tuple(int(-(-int(v) // 16) * 16) for v in span)
        lo_d = torch.from_numpy(lo.astype(np.int64)).to(cells_d.device)
        return _build_subgrid(cells_d, slots_d, lo_d, n_xyz), n_xyz, lo.astype(np.int64), 12
