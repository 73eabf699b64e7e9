"""Static-shape "unique" (counterpart of difusion_tpu/ops/segment.py's
``padded_unique_inverse``; its ``segment_sum`` is ``core/map._segment_sum``
here, and ``pack_batch``, ``groupby_max`` and ``pack_samples`` come with
training, which calls them).

Unique is a stable sort + boundary flags + a prefix sum, so every shape is
known up front and nothing reads a count on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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
