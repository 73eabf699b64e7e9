"""Several processes over ``torch.distributed`` (counterpart of
difusion_tpu/train/trainer.py:145-207: ``make_mesh``, ``shard_batch``,
``replicate``, ``shard_state_tp``).

:func:`make_mesh` lays the JAX package's ``(data, model)`` device mesh over
the ranks of a process group (``models/parallel.Mesh``, which also holds the
collectives the models' train forms call); :func:`shard_state_tp` shards
each weight matrix's output rows over the model coordinates by the JAX rule
:func:`spec_for`, and :func:`gather_state` puts the full tensors back for
checkpoints.

:func:`launch` runs a function on ``world`` spawned processes that meet on a
``FileStore`` (no TCP port, so concurrent test workers cannot collide);
every wait is bounded, and a rank that fails or hangs fails the launch.
Under ``torchrun`` the trainer forms its own process group
(``trainer.train``).
"""
from __future__ import annotations

import copy
import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..models.parallel import SINGLE, Mesh, gather_dim0, row_slice


def make_mesh(n_devices: int = -1, tp: int = 1) -> Mesh:
    """A 1-D data mesh, or a ``(data, model)`` mesh when ``tp`` > 1, over the
    first ``n_devices`` ranks of the initialised process group (all of them
    by default).  Every rank of the world must call it (the groups are
    collective).  With no process group it is a world of one."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = world if n_devices <= 0 else n_devices
    if n > world:
        raise RuntimeError(f"make_mesh: asked for {n} ranks but the process group has "
                           f"only {world}")
    if n % tp != 0:
        raise RuntimeError(f"make_mesh: {n} ranks not divisible by tp={tp}")
    dp = n // tp
    if n == 1:
        return SINGLE._replace(member=rank == 0)
    member = rank < n
    data_rank, model_rank = (rank // tp, rank % tp) if member else (0, 0)
    data_group = model_group = None
    # every rank creates every group, in the same order; the mesh's own
    # group leaves out the ranks past it, which may have left
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    for m in range(tp):
        g = dist.new_group([d * tp + m for d in range(dp)]) if dp > 1 else None
        if member and m == model_rank:
            data_group = g
    for d in range(dp):
        g = dist.new_group([d * tp + m for m in range(tp)]) if tp > 1 else None
        if member and d == data_rank:
            model_group = g
    return Mesh(dp, tp, data_rank, model_rank, data_group, model_group, member,
                group if member else None)


def shard_batch(mesh: Mesh, *tensors):
    """This rank's rows of each global-batch tensor (or numpy array) along
    the data axis: the contiguous slice ``PartitionSpec("data")`` gives."""
    out = []
    for t in tensors:
        if t.shape[0] % mesh.dp != 0:
            raise ValueError(f"shard_batch: batch {t.shape[0]} not divisible by "
                             f"dp={mesh.dp}")
        out.append(t[row_slice(mesh, t.shape[0] // mesh.dp)])
    return tuple(out)


def _state_tensors(state):
    """Every tensor of a train state by name: parameters, BatchNorm buffers
    and Adam's moments (``mu.<name>``, ``nu.<name>``)."""
    named = {f"dec.{n}": p for n, p in state.dec.named_parameters()}
    named.update({f"enc.{n}": p for n, p in state.enc.named_parameters()})
    named.update({f"enc.{n}": b for n, b in state.enc.named_buffers()})
    for name, (mu, nu) in state.opt.items():
        named[f"mu.{name}"], named[f"nu.{name}"] = mu, nu
    return named


def replicate(mesh: Mesh, state):
    """The state of the data group's first rank on every rank of the group
    (a broadcast, in place), as ``PartitionSpec()`` places it."""
    if mesh.dp > 1:
        src = dist.get_global_rank(mesh.data_group, 0)
        with torch.no_grad():
            for t in _state_tensors(state).values():
                dist.broadcast(t.data, src, group=mesh.data_group)
    return state


def spec_for(shape, tp: int) -> Optional[str]:
    """The JAX package's placement rule (trainer.py:192-197): the mesh axis
    that shards dim 0 of an array of ``shape``, or None (replicated)."""
    if len(shape) == 2 and shape[0] % tp == 0:
        return "model"
    if len(shape) == 1 and shape[0] % tp == 0 and shape[0] > 4:
        return "model"
    return None


def _full_rows(state) -> Dict[str, int]:
    """The full leading dimension of every tensor of :func:`_state_tensors`:
    each layer's output width (the std head's 1).  di_decoder only."""
    if not hasattr(state.dec.spec, "layer_dims"):
        raise NotImplementedError(f"{type(state.dec).__name__} has no tensor-parallel "
                                  f"layout ({state.dec.spec.NAME} trains in one process)")
    _, outs = state.dec.spec.layer_dims()
    rows = {}
    for i, layer in enumerate(state.dec.layers):
        rows.update({f"dec.layers.{i}.{k}": outs[i] for k in layer})
    rows.update({f"dec.uncertainty.{k}": 1 for k in state.dec.uncertainty})
    dims = state.enc.spec.all_dims
    for i, layer in enumerate(state.enc.layers):
        rows.update({f"enc.layers.{i}.{k}": dims[i + 1] for k in layer.keys()})
    for name in state.opt:
        rows[f"mu.{name}"] = rows[f"nu.{name}"] = rows[name]
    return rows


def _copy_state(state):
    dec, enc = copy.deepcopy(state.dec), copy.deepcopy(state.enc)
    return state._replace(dec=dec, enc=enc,
                          opt={n: (mu.clone(), nu.clone()) for n, (mu, nu) in state.opt.items()})


def _set(state, name: str, value: torch.Tensor) -> None:
    """Rebind the tensor ``name`` of :func:`_state_tensors` to ``value``."""
    kind, rest = name.split(".", 1)
    if kind in ("mu", "nu"):
        mu, nu = state.opt[rest]
        state.opt[rest] = (value, nu) if kind == "mu" else (mu, value)
        return
    module = state.dec if kind == "dec" else state.enc
    *path, leaf = rest.split(".")
    for p in path:
        module = module[int(p)] if p.isdigit() else getattr(module, p)
    if isinstance(module, torch.nn.ParameterDict):
        module[leaf] = torch.nn.Parameter(value)
    elif leaf in dict(module.named_buffers(recurse=False)):
        setattr(module, leaf, value)
    else:
        setattr(module, leaf, torch.nn.Parameter(value))


def shard_state_tp(state, mesh: Mesh):
    """Tensor-parallel placement over a ``(data, model)`` mesh: a new state
    whose tensors that :func:`spec_for` shards hold this rank's rows
    ``[m * rows / tp, (m + 1) * rows / tp)`` (parameters, BatchNorm buffers
    and Adam's moments alike); everything else, and ``step``, replicated."""
    out = _copy_state(state)
    if mesh.tp == 1:
        return out
    rows = _full_rows(out)
    for name, t in _state_tensors(out).items():
        if spec_for((rows[name],) + tuple(t.shape[1:]), mesh.tp) == "model":
            k = rows[name] // mesh.tp
            _set(out, name, t.data[mesh.model_rank * k:(mesh.model_rank + 1) * k].clone())
    return out


def gather_state(state, mesh: Mesh):
    """The full tensors of a sharded state (a new state; the state itself
    where nothing is sharded): checkpoints keep the single-process layout.
    Collective over the model group; every model rank gets them, rank 0
    writes them."""
    if mesh.tp == 1:
        return state
    out = _copy_state(state)
    rows = _full_rows(out)
    with torch.no_grad():
        for name, t in _state_tensors(out).items():
            if t.shape[0] < rows[name]:
                _set(out, name, gather_dim0(t.data, mesh))
    return out


def average_grads(mesh: Mesh, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean of each gradient over the data group: one all-reduce of a
    flat buffer in the dictionary's order, divided by its size."""
    if mesh.dp == 1:
        return grads
    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1) for n in names])
    dist.all_reduce(flat, group=mesh.data_group)
    flat = flat / torch.full((), float(mesh.dp), device=flat.device)
    return {n: part.view_as(grads[n])
            for n, part in zip(names, flat.split([grads[n].numel() for n in names]))}


def mean_over_data(mesh: Mesh, losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-rank losses (means over the rank's rows) -> the global batch's:
    their mean over the data group."""
    if mesh.dp == 1:
        return losses
    flat = torch.stack(list(losses.values()))
    dist.all_reduce(flat, group=mesh.data_group)
    flat = flat / torch.full((), float(mesh.dp), device=flat.device)
    return dict(zip(losses, flat.unbind()))


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh (nothing in a mesh of one).  The
    ranks past the mesh take no part: they may have left the group."""
    if mesh.size > 1:
        dist.barrier(group=mesh.group)


def leave_group() -> None:
    """Meet every rank of the default group once, then destroy it.  A rank
    with nothing to do (one past the mesh) would otherwise close its
    connections while a slower peer is still completing its side of gloo's
    full-mesh handshake in ``init_process_group``, which then fails with
    "Connection closed by peer".  The barrier waits at most the group's
    timeout."""
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Spawned ranks
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, tmp: str, backend: str, timeout: float) -> None:
    torch.set_num_threads(1)
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args, kwargs = pickle.load(f)
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        device = None
        if backend == "nccl":
            # one rank a card: NCCL's communicators and the rank's work on
            # card ``rank`` (mod the cards there are)
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout),
                                device_id=device)
        try:
            result = fn(*args, **kwargs)
        except BaseException:
            dist.destroy_process_group()
            raise
        # the result before the exit barrier: a rank that waits there for a
        # slower one has returned, and the parent does not count it as hung
        out = os.path.join(tmp, f"result_{rank}.pt")
        torch.save(result, out + ".tmp")
        os.replace(out + ".tmp", out)
        leave_group()
    except BaseException:                   # noqa: BLE001 -- reported to the parent
        Path(tmp, f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


def launch(fn: Callable, world: int, *args, backend: str = "gloo", timeout: float = 120.0,
           **kwargs) -> List[Any]:
    """``fn(*args, **kwargs)`` on ``world`` spawned processes inside an
    initialised process group (``backend``; each rank's collectives time out
    after ``timeout`` s): the list of the ranks' results, by rank.  ``fn``,
    its arguments and its results must pickle (a module-level function).
    Each rank runs torch on one thread; under NCCL rank r's current card
    is ``cuda:r`` (mod the cards there are).  The parent waits at most
    ``timeout`` s for all of them, kills those that remain, and raises
    RuntimeError, with the ranks' tracebacks, if any rank failed or
    hung."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="difusion_dist_") as tmp:
        # the call goes through a file: a process's arguments beyond a pipe's
        # buffer would hold each start until the rank before had imported
        # torch to unpickle them
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args, kwargs), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, tmp, backend, timeout))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        pending = list(procs)
        # until all have ended, one has failed (which leaves the others
        # waiting in a collective) or the time is up
        while pending and not any(p.exitcode not in (None, 0) for p in procs):
            left = deadline - time.monotonic()
            if left <= 0:
                break
            multiprocessing.connection.wait([p.sentinel for p in pending], left)
            pending = [p for p in pending if p.exitcode is None]
        hung = [r for r, p in enumerate(procs)
                if p.exitcode is None and not Path(tmp, f"result_{r}.pt").exists()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10.0)
        errors = sorted(Path(tmp).glob("error_*.txt"))
        codes = [p.exitcode for p in procs]
        if errors or hung or any(c != 0 for c in codes):
            detail = "\n".join(f"{e.name}:\n{e.read_text()}" for e in errors)
            raise RuntimeError(f"launch: {world} ranks of {getattr(fn, '__name__', fn)} "
                               f"ended with exit codes {codes} (hung ranks: {hung})"
                               f"\n{detail}")
        return [torch.load(Path(tmp) / f"result_{r}.pt", weights_only=False)
                for r in range(world)]
