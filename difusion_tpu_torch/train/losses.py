"""Training losses (counterpart of difusion_tpu/train/losses.py; parity with
the reference's pytorch/network/criterion.py).

Each loss takes prediction and target tensors plus the static config and
returns a dict of named scalar tensors; the trainer sums them.  Every loss
normalizes by ``n_samples``, the number of SDF samples in the batch.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch


class LossConfig(NamedTuple):
    """Static loss configuration (hyper.json "training_loss")."""
    types: Tuple[str, ...] = ("neg_log_likelihood", "reg_loss")
    enforce_minmax: bool = True
    clamping_distance: float = 0.2
    code_reg_lambda: float = 0.01
    siren_sdf_in: float = 1.0
    siren_sdf_out: float = 1.0
    siren_normal: float = 1.0
    siren_eikonal: float = 1.0

    @classmethod
    def from_hyper(cls, hyper: dict) -> "LossConfig":
        t = hyper["training_loss"]
        return cls(types=tuple(t["types"]),
                   enforce_minmax=t.get("enforce_minmax", True),
                   clamping_distance=t.get("clamping_distance", 0.2),
                   code_reg_lambda=t.get("code_reg_lambda", 0.01),
                   siren_sdf_in=t.get("siren_sdf_in", 1.0),
                   siren_sdf_out=t.get("siren_sdf_out", 1.0),
                   siren_normal=t.get("siren_normal", 1.0),
                   siren_eikonal=t.get("siren_eikonal", 1.0))


def _clamp_pair(cfg: LossConfig, pd, gt):
    if cfg.enforce_minmax:
        c = cfg.clamping_distance
        return torch.clamp(pd, -c, c), torch.clamp(gt, -c, c)
    return pd, gt


def l1_loss(cfg: LossConfig, pd_sdf, gt_sdf, n_samples) -> Dict[str, torch.Tensor]:
    """criterion.py:10-26."""
    pd, gt = _clamp_pair(cfg, pd_sdf, gt_sdf)
    return {"sdf": torch.sum(torch.abs(gt - pd)) / n_samples}


def neg_log_likelihood(cfg: LossConfig, pd_sdf, pd_sdf_std, gt_sdf,
                       n_samples) -> Dict[str, torch.Tensor]:
    """Gaussian NLL of the clamped target under N(pd, std) (criterion.py:29-43)."""
    pd, gt = _clamp_pair(cfg, pd_sdf, gt_sdf)
    std = pd_sdf_std
    ll = -0.5 * ((gt - pd) / std) ** 2 - torch.log(std) - 0.5 * math.log(2.0 * math.pi)
    return {"ll": -torch.sum(ll) / n_samples}


def reg_loss(cfg: LossConfig, latent_vecs, epoch, n_samples) -> Dict[str, torch.Tensor]:
    """Latent-norm regularizer with the 100-epoch ramp (criterion.py:88-93)
    over ``latent_vecs``, the latents as the decoder reads them (B*S rows in
    the trainer).  ``epoch`` is a host number."""
    l2 = torch.sum(torch.linalg.vector_norm(latent_vecs, dim=1))
    # min(1, epoch / 100) in f32, as the JAX package's jitted step computes
    # it (XLA turns the division by the constant into a product by 0.01)
    ramp = float(min(np.float32(1.0), np.float32(epoch) * np.float32(0.01)))
    return {"reg": ramp * l2 / n_samples * cfg.code_reg_lambda}


def siren_loss(cfg: LossConfig, pd_sdf, pd_grad, gt_normals,
               n_samples) -> Dict[str, torch.Tensor]:
    """SIREN-style boundary/eikonal losses (criterion.py:46-81).  Rows of
    ``gt_normals`` with zero norm are off-surface.  ``pd_grad`` = d pd_sdf /
    d xyz with its graph kept, so that the parameter gradient runs through
    it (the trainer's double backward)."""
    on_surface = torch.sum(torch.abs(gt_normals), dim=-1, keepdim=True) > 1e-6
    sdf_in = torch.where(on_surface, torch.abs(pd_sdf), 0.0)
    sdf_out = torch.where(on_surface, 0.0, torch.exp(-1e2 * torch.abs(pd_sdf)))
    cos = torch.sum(pd_grad * gt_normals, dim=-1, keepdim=True) / (
        torch.linalg.vector_norm(pd_grad, dim=-1, keepdim=True)
        * torch.linalg.vector_norm(gt_normals, dim=-1, keepdim=True) + 1e-12)
    normal = torch.where(on_surface, 1.0 - cos, 0.0)
    eikonal = torch.abs(torch.linalg.vector_norm(pd_grad, dim=-1) - 1.0)
    return {
        "sdf_in": torch.sum(sdf_in) / n_samples * cfg.siren_sdf_in,
        "sdf_out": torch.sum(sdf_out) / n_samples * cfg.siren_sdf_out,
        "normal": torch.sum(normal) / n_samples * cfg.siren_normal,
        "eikonal": torch.sum(eikonal) / n_samples * cfg.siren_eikonal,
    }
