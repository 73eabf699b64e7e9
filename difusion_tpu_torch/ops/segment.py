"""Static-shape segment and group-by primitives (counterpart of
difusion_tpu/ops/segment.py; on the map's paths its ``segment_sum`` is
``core/map._segment_sum``, which sorts once on the card).

Unique is a stable sort + boundary flags + a prefix sum, so every shape is
known up front and nothing reads a count on the host.  ``pack_samples``
takes its random draws as arguments where the JAX package takes a key.
Only ``padded_unique_inverse`` is on a path of the port (the latent
optimizer); the others are the JAX package's helpers, which its own tests
call and no path of either package does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class PaddedUnique(NamedTuple):
    """``inverse``: (N,) int64 segment id in [0, N) per element; equal values
    share an id, ids are dense and ordered by value.  ``count``: () int64
    device tensor, the number of distinct valid values (the trailing segment
    of invalid elements is not counted)."""
    inverse: torch.Tensor
    count: torch.Tensor


def padded_unique_inverse(ids: torch.Tensor,
                          valid: Optional[torch.Tensor] = None) -> PaddedUnique:
    """Dense segment ids for equal values of an int32 ``ids`` (N,).  With
    ``valid``, invalid elements become ``iinfo(int32).max``, sort last and
    share one segment that ``count`` leaves out.  The sort is stable, as the
    JAX ``argsort`` is."""
    n = ids.shape[0]
    if valid is not None:
        ids = torch.where(valid, ids, torch.iinfo(ids.dtype).max)
    sorted_ids, order = torch.sort(ids, stable=True)
    first = torch.ones(n, dtype=torch.int64, device=ids.device)
    first[1:] = (sorted_ids[1:] != sorted_ids[:-1]).to(torch.int64)
    seg_sorted = torch.cumsum(first, 0) - 1
    inverse = torch.empty_like(seg_sorted).scatter_(0, order, seg_sorted)
    count = seg_sorted[-1] + 1
    if valid is not None:
        count = count - (~valid).any().to(torch.int64)
    return PaddedUnique(inverse=inverse, count=count)


def _segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """Sum of rows by id into ``num_segments`` rows; ids outside the range
    are dropped (``jax.ops.segment_sum``)."""
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(ok, segment_ids, num_segments).to(torch.int64)
    out = values.new_zeros((num_segments + 1, *values.shape[1:]))
    return out.index_add_(0, ids, values)[:-1]


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted segment sum of ``values`` (N, L) or (N,) by ids (N,) into
    ``num_segments`` rows; ids outside the range drop."""
    if weights is not None:
        w = weights.to(values.dtype)
        values = values * (w[:, None] if values.ndim == 2 else w)
    return _segment_sum(values, segment_ids, num_segments)


def segment_mean(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 weights: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted segment mean and counts of ``values`` (N, L) or (N,), the
    reference's ``groupby_reduce`` (pytorch/network/utility.py:186-208);
    empty segments get mean 0."""
    sums = segment_sum(values, segment_ids, num_segments, weights)
    ones = (values.new_ones(values.shape[0]) if weights is None
            else weights.to(values.dtype))
    counts = _segment_sum(ones, segment_ids, num_segments)
    denom = torch.clamp(counts, min=1e-12)
    return sums / (denom[:, None] if values.ndim == 2 else denom), counts


def pack_batch(group_ids: torch.Tensor, n_batch: int, n_point: int,
               valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``n_point`` sample indices per group in (n_batch, n_point) slots
    (the reference's ``pack_batch``, system/ext/indexing/indexing.cu:17-35),
    filled in index order within a group (a stable sort gives each sample its
    rank).  Returns (packed int32 with -1 padding, counts (n_batch,) int32
    clamped to n_point)."""
    n = group_ids.shape[0]
    dev = group_ids.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    g = torch.where(valid & (group_ids >= 0) & (group_ids < n_batch),
                    group_ids, n_batch).to(torch.int64)
    g_s, order = torch.sort(g, stable=True)
    idx = torch.arange(n, device=dev)
    start = torch.full((n_batch + 1,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, g_s, idx, "amin")
    rank = idx - start[g_s]
    ok = (g_s < n_batch) & (rank < n_point)
    flat = torch.where(ok, g_s * n_point + rank, n_batch * n_point)
    packed = torch.full((n_batch * n_point + 1,), -1, dtype=torch.int64, device=dev)
    packed[flat[ok]] = order[ok]
    counts = torch.zeros(n_batch + 1, dtype=torch.int64, device=dev).index_add_(
        0, g_s, torch.ones_like(g_s))[:-1]
    return (packed[:-1].reshape(n_batch, n_point).to(torch.int32),
            torch.clamp(counts, max=n_point).to(torch.int32))


def groupby_max(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Segment max (``jax.ops.segment_max``): empty segments hold the
    dtype's lowest value (-inf for floats), ids outside the range drop."""
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(ok, segment_ids, num_segments).to(torch.int64)
    low = (-torch.inf if values.is_floating_point()
           else torch.iinfo(values.dtype).min)
    out = torch.full((num_segments + 1, *values.shape[1:]), low, dtype=values.dtype,
                     device=values.device)
    index = ids.reshape(-1, *([1] * (values.ndim - 1))).expand_as(values)
    return out.scatter_reduce_(0, index, values, "amax")[:-1]


def pack_samples(sample_indexer: torch.Tensor, count: int, shuffle: torch.Tensor,
                 uniform: torch.Tensor, max_batches: int,
                 sample_values: Optional[torch.Tensor] = None):
    """Random per-group subsample of fixed size (the reference's
    ``pack_samples``, pytorch/network/utility.py:152-183): shuffle, pack up
    to 2*count indices per group, then draw ``count`` of them with
    replacement.  ``shuffle``: a permutation of the N samples; ``uniform``:
    (max_batches, count) draws in [0, 1).  Returns (packed (B, count, L), or
    the indices (B, count), and group_valid (B,))."""
    shuffle = shuffle.to(torch.int64)
    uq = padded_unique_inverse(sample_indexer[shuffle])
    packed_inds, pcount = pack_batch(uq.inverse, max_batches, 2 * count)
    pcount = torch.clamp(pcount, 0, 2 * count - 1)
    pick = torch.floor(uniform * torch.clamp(pcount, min=1)[:, None]).to(torch.int64)
    inds = torch.gather(packed_inds, 1, pick).to(torch.int64)
    inds = shuffle[torch.clamp(inds, min=0)]
    group_valid = ((torch.arange(max_batches, device=inds.device) < uq.count)
                   & (pcount > 0))
    if sample_values is not None:
        return sample_values[inds.reshape(-1)].reshape(max_batches, count, -1), group_valid
    return inds.to(torch.int32), group_valid
