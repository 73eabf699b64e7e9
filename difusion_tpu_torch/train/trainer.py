"""Joint encoder/decoder prior training (counterpart of
difusion_tpu/train/trainer.py; parity with the reference's
pytorch/network_trainer.py, config surface = ckpt/default/hyper.json).

    python -m difusion_tpu_torch.train.trainer configs/train-study-mixed.yaml \
        [--set k=v] [--device cpu]
    torchrun --standalone --nproc-per-node N -m difusion_tpu_torch.train.trainer ...

* One train step: the encoder in 'train' mode over (B, N, 6) surface samples,
  the codes tiled to (B*S, L), the decoder's NLL and the latent regularizer
  (or the configured losses), the gradient by autograd and Adam as optax
  computes it (``utils/adam.py``): optax's ``adam(1.0)`` with each group's
  update scaled by its schedule's learning rate (group 0 the decoder, group
  1 the encoder).  BatchNorm running statistics move with the forward pass.
  The reference's ``batch_split`` is accepted and ignored, as in the JAX
  package: the whole batch is one step.
* Data parallelism, as the JAX package's ``train`` meshes its devices: under
  ``torchrun`` (or in a process group the caller formed) the step runs over
  ``gcd(batch_size, world)`` ranks, NCCL on ``cuda:LOCAL_RANK`` (gloo with
  ``--device cpu``); see :func:`train`.  Without a launcher, one process on
  one card.  Tensor parallelism is reached through ``distributed.py``'s
  helpers (``make_mesh(n, tp)``, ``shard_state_tp``), as in the JAX
  package, not through ``train``.
* The host reads the losses every ``log_every`` steps only.
* Outputs, as the JAX package writes them: ``metrics.jsonl`` (one row per log
  interval), ``hyper.json``, ``prior_{E}.npz`` (read by
  ``models/weights.load_prior`` and by the JAX package) and the reference's
  ``model_{E}.pth.tar`` / ``encoder_{E}.pth.tar`` at the snapshot epochs,
  and ``training_{E}.npz`` with the optimizer state for ``resume_epoch``.
"""
from __future__ import annotations

import contextlib
import datetime
import json
import logging
import math
import os
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models import weights
from ..models.decoder import init_params, is_conditioned, spec_from_hyper, train_decoder
from ..models.encoder import EncoderSpec, EncoderTrain, init_encoder_params
from ..utils.adam import adam_step, bias_corrections
from ..utils.meters import LossMeter
from . import distributed as D
from . import lif_dataset as ldata
from .losses import LossConfig, l1_loss, neg_log_likelihood, reg_loss, siren_loss
from .lr_schedule import get_learning_rate_schedules

# the longest a rank waits in a collective or to form the group under torchrun
PG_TIMEOUT = datetime.timedelta(seconds=600)


class TrainState(NamedTuple):
    """The decoder and encoder (parameters and BatchNorm buffers on the
    device), Adam's moments by parameter name (``dec.layers.0.g``,
    ``enc.layers.3.b``), and the number of steps taken (a host count)."""
    dec: torch.nn.Module     # DecoderTrain, CbnDecoderTrain or FilmDecoderTrain
    enc: EncoderTrain
    opt: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    step: int


def _named_params(dec: torch.nn.Module, enc: EncoderTrain):
    return ([(f"dec.{n}", p) for n, p in dec.named_parameters()]
            + [(f"enc.{n}", p) for n, p in enc.named_parameters()])


def state_from_params(spec_d, spec_e: EncoderSpec, dec_params, enc_params,
                      device) -> TrainState:
    """A fresh state (zero moments, step 0) from JAX-layout trees; the
    decoder's train form is its spec's family's."""
    dec = train_decoder(spec_d, dec_params).to(device)
    enc = EncoderTrain(spec_e, enc_params).to(device)
    return TrainState(dec, enc, {n: (torch.zeros_like(p), torch.zeros_like(p))
                                 for n, p in _named_params(dec, enc)}, 0)


def create_train_state(spec_d, spec_e: EncoderSpec, seed: int = 0,
                       device="cuda") -> TrainState:
    """Parameters drawn from a CPU ``torch.Generator`` seeded ``seed``
    (decoder first, then encoder), moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    dec = init_params(spec_d, gen)
    enc = init_encoder_params(spec_e, gen)
    return state_from_params(spec_d, spec_e, dec, enc, resolve_device(device))


def forward_losses(loss_cfg: LossConfig, state: TrainState, sdf_data: torch.Tensor,
                   surface: torch.Tensor, epoch,
                   masks: Optional[Dict[int, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None,
                   mesh: Optional[D.Mesh] = None
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The training forward pass, its autograd graph kept: the losses (0-d
    device tensors, ``total`` last) and the decoded sdf (B*S, 1).  It moves
    the BatchNorm running statistics.  sdf_data (B, S, 4) xyz+sdf
    (xyz+normal for ``siren_loss``) in voxel-local coordinates, surface (B,
    N, 6) xyz+normal; either may arrive as float16 (the ``upload_dtype``
    option) and is computed in f32.  Dropout draws from ``generator``, or
    takes ``masks`` (the decoder's per-layer keeps, for tests).  With a
    ``mesh`` (``distributed.make_mesh``) the batch is this rank's rows of
    the global batch (``distributed.shard_batch``), the masks the global
    batch's, and the losses are means over this rank's rows: their mean
    over the data group is the global batch's."""
    sdf_data = sdf_data.float()
    surface = surface.float()
    B, S, _ = sdf_data.shape
    # divisors as 0-d device tensors: CUDA divides by a host scalar as a
    # product by its reciprocal, the JAX package by true division
    n_samples = torch.full((), float(B * S), device=sdf_data.device)
    xyz = sdf_data[:, :, 0:3].reshape(-1, 3)
    gt_sdf = sdf_data[:, :, 3:].reshape(B * S, -1)
    need_grad = "siren_loss" in loss_cfg.types

    conditioned = is_conditioned(state.dec.spec)
    if conditioned and mesh is not None and mesh.size > 1:
        raise NotImplementedError(f"{state.dec.spec.NAME} trains in one process: its data- "
                                  "and tensor-parallel steps are not written")
    with torch.enable_grad():
        codes = state.enc(surface, mesh=mesh)                        # (B, L)
        lat = torch.repeat_interleave(codes, S, dim=0)               # (B*S, L)
        if need_grad:
            xyz = xyz.detach().requires_grad_(True)
        if conditioned:
            # the conditioning once a LIF, broadcast over its S samples
            pd_sdf, pd_std = state.dec(codes, xyz)
        else:
            pd_sdf, pd_std = state.dec(torch.cat([lat, xyz], dim=1), masks=masks,
                                       generator=generator, mesh=mesh)
        # d sdf / d xyz inside the loss: the parameter gradient runs through it
        pd_grad = (torch.autograd.grad(pd_sdf.sum(), xyz, create_graph=True)[0]
                   if need_grad else None)
        losses: Dict[str, torch.Tensor] = {}
        for t in loss_cfg.types:
            if t == "l1_loss":
                losses.update(l1_loss(loss_cfg, pd_sdf, gt_sdf[:, 0:1], n_samples))
            elif t == "neg_log_likelihood":
                losses.update(neg_log_likelihood(loss_cfg, pd_sdf, pd_std,
                                                 gt_sdf[:, 0:1], n_samples))
            elif t == "reg_loss":
                losses.update(reg_loss(loss_cfg, lat, epoch, n_samples))
            elif t == "siren_loss":
                losses.update(siren_loss(loss_cfg, pd_sdf, pd_grad, gt_sdf, n_samples))
            else:
                raise ValueError(f"unknown loss {t!r}")
        losses["total"] = sum(losses.values())
    return losses, pd_sdf


def loss_and_grads(loss_cfg: LossConfig, state: TrainState, sdf_data: torch.Tensor,
                   surface: torch.Tensor, epoch,
                   masks: Optional[Dict[int, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None,
                   mesh: Optional[D.Mesh] = None
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """:func:`forward_losses` (same arguments), then the gradient of
    ``total`` by parameter name; the losses come back detached, with the
    surface-SDF validation probe (network_trainer.py:174-181).  With a
    ``mesh`` the gradients are averaged over the data group (the global
    batch's); the losses stay this rank's (``distributed.mean_over_data``
    gives the global batch's)."""
    params = _named_params(state.dec, state.enc)
    losses, pd_sdf = forward_losses(loss_cfg, state, sdf_data, surface, epoch,
                                    masks=masks, generator=generator, mesh=mesh)
    grads = torch.autograd.grad(losses["total"], [p for _, p in params], allow_unused=True)
    total = losses.pop("total").detach()
    # detached, so that the step's graph goes with this call
    losses = {k: v.detach() for k, v in losses.items()}
    losses["surface_abs_sdf"] = torch.mean(torch.abs(pd_sdf.detach()))
    losses["total"] = total
    # a parameter no loss reads has a zero gradient, as under jax.grad
    grads = {name: (g if g is not None else torch.zeros_like(p))
             for (name, p), g in zip(params, grads)}
    if mesh is not None:
        grads = D.average_grads(mesh, grads)
    return losses, grads


def train_step(loss_cfg: LossConfig, state: TrainState, sdf_data: torch.Tensor,
               surface: torch.Tensor, lr_dec: float, lr_enc: float, epoch,
               masks: Optional[Dict[int, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None,
               mesh: Optional[D.Mesh] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step (:func:`loss_and_grads`, then Adam), in place on
    the state's modules and moments.  Returns the state with ``step + 1``
    and the losses as 0-d device tensors: nothing is read on the host.
    Adam runs on replicated and sharded tensors alike."""
    losses, grads = loss_and_grads(loss_cfg, state, sdf_data, surface, epoch,
                                   masks=masks, generator=generator, mesh=mesh)
    step = state.step + 1
    dev = sdf_data.device
    bc1, bc2 = (torch.full((), float(b), device=dev) for b in bias_corrections(step))
    with torch.no_grad():
        for name, p in _named_params(state.dec, state.enc):
            mu, nu = state.opt[name]
            lr = lr_dec if name.startswith("dec.") else lr_enc
            new_p, mu, nu = adam_step(p, grads[name], mu, nu, bc1, bc2, float(lr))
            p.copy_(new_p)
            state.opt[name] = (mu, nu)
    return state._replace(step=step), losses


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------


def save_checkpoint(save_dir: Path, epoch: int, state: TrainState, hyper: dict) -> None:
    """hyper.json (if absent), prior_E.npz, the reference's model_E.pth.tar /
    encoder_E.pth.tar, and training_E.npz.  training_E.npz is the port's own
    layout: ``step`` and Adam's moments as ``mu.<name>`` / ``nu.<name>`` by
    parameter name (the JAX package's file holds optax's flattened state)."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    hyper_path = save_dir / "hyper.json"
    if not hyper_path.exists():
        hyper_path.write_text(json.dumps(hyper, indent=2, default=str))
    dec_np, enc_np = state.dec.to_params(), state.enc.to_params()
    weights.save_params_npz(save_dir / f"prior_{epoch}.npz", decoder=dec_np, encoder=enc_np)
    if not is_conditioned(state.dec.spec):
        # the reference's layout exists for di_decoder only
        weights.save_torch_prior(save_dir, epoch, dec_np, enc_np, hyper)
    moments = {}
    for name, (mu, nu) in state.opt.items():
        moments[f"mu.{name}"] = mu.cpu().numpy()
        moments[f"nu.{name}"] = nu.cpu().numpy()
    np.savez_compressed(save_dir / f"training_{epoch}.npz", step=np.int64(state.step),
                        **moments)


def load_checkpoint(save_dir: Path, epoch: int, spec_d, spec_e: EncoderSpec,
                    device="cuda") -> TrainState:
    """prior_E.npz (the port's or the JAX package's), with the optimizer
    state of the port's training_E.npz where there is one; else zero moments
    at step 0."""
    save_dir = Path(save_dir)
    dev = resolve_device(device)
    loaded = weights.load_params_npz(save_dir / f"prior_{epoch}.npz")
    state = state_from_params(spec_d, spec_e, loaded["decoder"], loaded["encoder"], dev)
    tpath = save_dir / f"training_{epoch}.npz"
    if tpath.exists():
        with np.load(tpath) as data:
            if not any(k.startswith("mu.") for k in data.files):
                raise ValueError(f"{tpath} is not the port's optimizer state (the JAX "
                                 "package's layout?); remove it to resume with "
                                 "fresh moments")
            opt = {n: (torch.from_numpy(data[f"mu.{n}"]).to(dev),
                       torch.from_numpy(data[f"nu.{n}"]).to(dev)) for n in state.opt}
            state = state._replace(opt=opt, step=int(data["step"]))
    return state


# ---------------------------------------------------------------------------
# Training loop (network_trainer.py main)
# ---------------------------------------------------------------------------


def _torchrun_group(dev: torch.device) -> torch.device:
    """Form the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``): NCCL
    on ``cuda:LOCAL_RANK``, gloo for ``device="cpu"``.  Returns this rank's
    device; a group that does not form raises."""
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, timeout=PG_TIMEOUT)
    else:
        dist.init_process_group("gloo", timeout=PG_TIMEOUT)
    return dev


def train(args, max_steps: int = -1, log_every: int = 10,
          device="cuda") -> Optional[TrainState]:
    """Run the training loop from a reference-style hyper namespace or dict
    on ``device`` (the card unless the caller asks for the CPU).

    In a process group (formed by the caller, or from ``torchrun``'s
    environment, which :func:`_torchrun_group` reads) the step is data
    parallel over the first ``gcd(batch_size, world)`` ranks, as the JAX
    package's ``train`` meshes ``gcd(batch_size, len(jax.devices()))``
    devices: every rank builds the same global batch and uploads its rows,
    the state is replicated from the first rank, the gradients and the
    logged losses are the global batch's, and rank 0 writes the files while
    the others wait.  The ranks past the mesh sit out, as the devices past
    the JAX mesh do: they return None.  With no process group it is one
    process, as before."""
    dev = resolve_device(device)
    formed = False
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        dev = _torchrun_group(dev)
        formed = True
    try:
        return _train(args, max_steps, log_every, dev)
    finally:
        if formed:
            dist.destroy_process_group()


def _train(args, max_steps: int, log_every: int, dev: torch.device) -> Optional[TrainState]:
    hyper = vars(args) if not isinstance(args, dict) else args
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = D.make_mesh(math.gcd(int(hyper["batch_size"]), world))
    if not mesh.member:
        logging.info("rank %d sits out: the data mesh holds %d of %d ranks",
                     dist.get_rank(), mesh.size, world)
        return None
    multi = mesh.size > 1
    lead = mesh.rank == 0
    if multi:
        logging.info("data-parallel over %d ranks", mesh.size)
    spec_d = spec_from_hyper(hyper)
    if multi and is_conditioned(spec_d):
        raise NotImplementedError(f"{spec_d.NAME} trains in one process: its data-parallel "
                                  "step is not written")
    spec_e = EncoderSpec.from_hyper(hyper)
    loss_cfg = LossConfig.from_hyper(hyper)
    schedules = get_learning_rate_schedules(hyper["lr_schedule"])

    dataset = ldata.LifCombinedDataset(*[
        ldata.LifDataset(**t, num_sample=hyper["samples_per_lif"])
        for t in hyper["train_set"]])
    logging.info("dataset: %d LIFs", len(dataset))
    # `loader: packed` (default) assembles whole batches as vectorized numpy
    # gathers over epoch-level pre-packed arrays; `loader: threaded` keeps the
    # per-item thread pool for corpora too big to pack in RAM
    loader_kind = str(hyper.get("loader", "packed"))
    packed = ldata.pack_dataset(dataset) if loader_kind == "packed" else None
    if packed is not None:
        logging.info("packed loader: %.1f MB resident",
                     sum(a.nbytes for p in getattr(packed, "packs", [packed])
                         for a in (p.pos, p.neg, p.surf)) / 1e6)

    # epoch-level resume: `resume_epoch: E` reloads prior_E.npz (+ the
    # optimizer state) and continues at epoch E+1
    start_epoch = int(hyper.get("resume_epoch", 0))
    save_dir = Path(hyper.get("save_dir", f"./di-checkpoints/{hyper['run_name']}"))
    if start_epoch > 0:
        state = load_checkpoint(save_dir, start_epoch, spec_d, spec_e, dev)
        logging.info("resumed from epoch %d", start_epoch)
    else:
        state = create_train_state(spec_d, spec_e, 0, dev)
    state = D.replicate(mesh, state)
    checkpoints = sorted(set(
        list(range(hyper["snapshot_frequency"], hyper["num_epochs"] + 1,
                   hyper["snapshot_frequency"]))
        + list(hyper.get("additional_snapshots", []))))

    if lead:
        save_dir.mkdir(parents=True, exist_ok=True)
    upload = (np.float16 if str(hyper.get("upload_dtype", "float32")) == "float16"
              else np.float32)
    rng = np.random.default_rng(start_epoch)
    dropout_gen = torch.Generator(device=dev).manual_seed(1 + start_epoch)
    it = 0
    # on resume the logged iteration axis continues from the snapshot's step,
    # while `it` counts this call's steps (max_steps)
    it_base = state.step if start_epoch > 0 else 0
    with (open(save_dir / "metrics.jsonl", "a") if lead else contextlib.nullcontext()) \
            as metrics_f:
        for epoch in range(start_epoch + 1, hyper["num_epochs"] + 1):
            lr_dec = schedules[0](epoch)
            lr_enc = schedules[1](epoch)
            meter = LossMeter()
            t_epoch = time.perf_counter()
            n_batches = 0
            batches = (ldata.iterate_batches_packed(packed, hyper["batch_size"], rng)
                       if packed is not None else
                       ldata.iterate_batches(dataset, hyper["batch_size"], rng,
                                             n_workers=int(hyper.get("loader_workers", 4))))
            if multi:
                # every rank assembles the global batch and uploads its rows
                batches = (D.shard_batch(mesh, sdf, surf) + (ids,)
                           for sdf, surf, ids in batches)
            for sdf_data, surface, _ in ldata.prefetch_device(batches, dev, upload):
                state, losses = train_step(loss_cfg, state, sdf_data, surface, lr_dec,
                                           lr_enc, epoch, generator=dropout_gen,
                                           mesh=mesh if multi else None)
                it += 1
                n_batches += 1
                if it % log_every == 0:
                    losses = D.mean_over_data(mesh, losses)
                    vals = dict(zip(losses, torch.stack(list(losses.values())).tolist()))
                    meter.update(vals)
                    logging.info("epoch %d it %d: %s", epoch, it,
                                 {k: round(v, 5) for k, v in vals.items()})
                    if lead:
                        metrics_f.write(json.dumps(
                            {"epoch": epoch, "it": it_base + it, "lr_dec": float(lr_dec),
                             "lr_enc": float(lr_enc), "t": time.time(), **vals}) + "\n")
                        metrics_f.flush()
                if 0 < max_steps <= it:
                    break
            dt = time.perf_counter() - t_epoch
            if n_batches:
                logging.info("epoch %d done: %.2f it/s  %s", epoch, n_batches / dt,
                             meter.summary())
            if epoch in checkpoints:
                full = D.gather_state(state, mesh)
                if lead:
                    save_checkpoint(save_dir, epoch, full, hyper)
                D.barrier(mesh)
            if 0 < max_steps <= it:
                break
    return state


def main(argv=None):
    from ..config import ArgumentParserX
    parser = ArgumentParserX(add_hyper_arg=True,
                             description="difusion-tpu prior trainer (PyTorch)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    device = args.device
    del args.device
    logging.basicConfig(level=logging.INFO)
    return train(args, device=device)


if __name__ == "__main__":
    main()
