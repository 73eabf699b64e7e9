"""What each spawned rank of tests/test_torch_distributed.py runs
(``difusion_tpu_torch.train.distributed.launch`` pickles these functions by
name, so they live in a module that the ranks import without JAX)."""
import os
import time
from pathlib import Path

import torch
import torch.distributed as dist

from difusion_tpu_torch.models import parallel as P
from difusion_tpu_torch.models.decoder import DecoderSpec
from difusion_tpu_torch.models.encoder import EncoderSpec
from difusion_tpu_torch.train import distributed as D
from difusion_tpu_torch.train import trainer as TR
from difusion_tpu_torch.train.losses import LossConfig


def step(dec_np, enc_np, sdf, surf, masks, lr, epoch, n=-1, tp=1, steps=1):
    """``steps`` train steps of the default networks on a ``make_mesh(n,
    tp)`` mesh from the given JAX-layout trees and global batch (numpy);
    rank 0 returns the losses of the global batch (the last step's) and the
    gathered parameter trees, the other ranks their local tensor shapes."""
    mesh = D.make_mesh(n, tp)
    state = TR.state_from_params(DecoderSpec(), EncoderSpec(), dec_np, enc_np,
                                 torch.device("cpu"))
    state = D.shard_state_tp(D.replicate(mesh, state), mesh)
    sdf_s, surf_s = D.shard_batch(mesh, torch.from_numpy(sdf), torch.from_numpy(surf))
    masks_t = {i: torch.from_numpy(m) for i, m in masks.items()} if masks else None
    for _ in range(steps):
        state, losses = TR.train_step(LossConfig(), state, sdf_s, surf_s, lr, lr, epoch,
                                      masks=masks_t, mesh=mesh)
    losses = {k: float(v) for k, v in D.mean_over_data(mesh, losses).items()}
    shapes = {n: tuple(t.shape) for n, t in D._state_tensors(state).items()}
    full = D.gather_state(state, mesh)
    if mesh.rank != 0:
        return {"shapes": shapes}
    return {"losses": losses, "dec": full.dec.to_params(), "enc": full.enc.to_params(),
            "shapes": shapes, "mesh": (mesh.dp, mesh.tp), "step": full.step}


def train(hyper, max_steps):
    """``trainer.train`` on the CPU inside the launched group."""
    state = TR.train(hyper, max_steps=max_steps, log_every=1, device="cpu")
    return None if state is None else state.step


def fail_on_rank(bad_rank):
    """Rank ``bad_rank`` raises before the all-reduce that the others enter."""
    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    dist.all_reduce(torch.ones(1))


def hang_on_rank(bad_rank, seconds):
    """Rank ``bad_rank`` sleeps past the launch's time limit."""
    if dist.get_rank() == bad_rank:
        time.sleep(seconds)
    return dist.get_rank()


def mesh_coords(n, tp):
    """This rank's mesh and a gather of its model rank over the model group."""
    mesh = D.make_mesh(n, tp)
    if not mesh.member:
        return None
    x = torch.full((2, 3), float(mesh.model_rank))
    return (mesh.dp, mesh.tp, mesh.data_rank, mesh.model_rank,
            P.gather_cols(x, mesh).numpy() if mesh.tp > 1 else x.numpy())


def _alive(pid):
    """Whether process ``pid`` runs (an exited one not yet reaped is a
    zombie, and counts as gone)."""
    try:
        os.kill(pid, 0)
        return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0] != "Z"
    except (ProcessLookupError, FileNotFoundError):
        return False


def outlive_peers(pid_dir, seconds):
    """Every rank writes its pid; then rank 0 sleeps ``seconds`` while the
    others return at once, and returns the ranks whose processes are gone."""
    rank = dist.get_rank()
    Path(pid_dir, str(rank)).write_text(str(os.getpid()))
    dist.barrier()
    if rank != 0:
        return None
    time.sleep(seconds)
    return [r for r in range(1, dist.get_world_size())
            if not _alive(int(Path(pid_dir, str(r)).read_text()))]

