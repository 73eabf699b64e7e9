"""A rank's place in a ``(data, model)`` mesh of processes, and the
collectives the train forms of the models call on it (the counterpart of
what GSPMD inserts under the JAX package's mesh).

A :class:`Mesh` lays the JAX package's device mesh over process ranks: rank
``d * tp + m`` holds data coordinate ``d`` and model coordinate ``m``, as
``np.array(devices).reshape(n // tp, tp)`` orders them.  Data parallelism
splits the global batch into contiguous row slices, one per data
coordinate (``PartitionSpec("data")``); tensor parallelism shards each
weight matrix's output rows over the model coordinates (column-parallel).
``train/distributed.py`` builds meshes (``make_mesh``) and places states;
``models/encoder.py`` and ``models/decoder.py`` call:

* :func:`all_reduce_sum` over the data group: BatchNorm's global statistics;
  its backward all-reduces the gradient, so the cross-rank terms stay;
* :func:`copy_to_model`: a sharded layer's input; its backward sums the
  gradient over the model group (each rank's slice of outputs gives its
  share of it);
* :func:`gather_cols` over the model group: a sharded layer's slice of
  outputs back to the full activation; its backward keeps the rank's own
  slice (every model rank computes the same loss from the same rows);
* :func:`slice_cols`: the rank's slice of a tensor that is the same on
  every model rank; its backward gathers.

An all-gather is written as an all-reduce of a zero-filled full buffer:
exact (it adds zeros), and carried by NCCL and by gloo alike, also for
CUDA tensors (gloo: ranks that share one card).  Every tensor a collective
gets is contiguous (NCCL refuses others; a gradient may arrive strided).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """This rank's place in a ``(data, model)`` mesh of ``dp * tp`` ranks.
    ``member`` is false on a rank outside the mesh (a world larger than
    the mesh).  ``group`` holds every rank of the mesh, ``data_group`` this
    rank's model coordinate over the data axis, ``model_group`` its data
    coordinate over the model axis; a group is None where it would hold
    one rank."""
    dp: int
    tp: int
    data_rank: int
    model_rank: int
    data_group: Any
    model_group: Any
    member: bool = True
    group: Any = None

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def rank(self) -> int:
        return self.data_rank * self.tp + self.model_rank


SINGLE = Mesh(1, 1, 0, 0, None, None)


def row_slice(mesh: Optional[Mesh], n_local: int) -> slice:
    """The rows of a global batch of ``n_local * dp`` rows that this rank's
    data coordinate holds."""
    d = mesh.data_rank if mesh is not None else 0
    return slice(d * n_local, (d + 1) * n_local)


def gather_dim0(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """All-gather along dim 0 over the model group, as an all-reduce of a
    zero-filled full buffer."""
    k = t.shape[0]
    full = t.new_zeros((k * mesh.tp,) + tuple(t.shape[1:]))
    full[mesh.model_rank * k:(mesh.model_rank + 1) * k] = t
    dist.all_reduce(full, group=mesh.model_group)
    return full


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return gather_dim0(x.movedim(-1, 0), mesh).movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _SliceCols.apply(g, ctx.mesh), None


class _SliceCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        k = x.shape[-1] // mesh.tp
        return x[..., mesh.model_rank * k:(mesh.model_rank + 1) * k].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _GatherCols.apply(g, ctx.mesh), None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromModel.apply(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _CopyToModel.apply(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; autograd all-reduces its gradient."""
    return _AllReduceSum.apply(x, group)


def gather_cols(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The model group's slices of the last dimension, concatenated in model
    order; autograd keeps this rank's slice of the gradient."""
    return _GatherCols.apply(x, mesh)


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` (the same on every model rank) as the input of a sharded layer:
    autograd sums the gradient over the model group, since each rank's
    slice of outputs gives only its share of it."""
    return _CopyToModel.apply(x, mesh.model_group)


def slice_cols(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the last dimension of a tensor that every model
    rank holds alike; autograd gathers the gradient's slices."""
    return _SliceCols.apply(x, mesh)
