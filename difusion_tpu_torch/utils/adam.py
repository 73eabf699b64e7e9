"""Adam as optax's ``adam`` computes it (``scale_by_adam`` then a scale by
``-lr``), written out so that the latent optimizer (``core/map.py``) and the
prior trainer (``train/trainer.py``) take the same steps as the JAX package.

``bc1``, ``bc2`` are the bias corrections ``1 - b^t`` of step ``t`` (1-based)
in f32, as scalars or 0-d tensors; :func:`bias_corrections` gives them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def bias_corrections(steps) -> Tuple[np.ndarray, np.ndarray]:
    """(1 - b1^t, 1 - b2^t) in f32 for the 1-based steps ``steps``."""
    t = np.asarray(steps, dtype=np.float32)
    return tuple(np.float32(1) - np.float32(b) ** t for b in (B1, B2))


def adam_step(param: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
              bc1, bc2, lr) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step: (new param, new first moment, new second moment)."""
    mu = (1 - B1) * g + B1 * mu
    nu = (1 - B2) * (g * g) + B2 * nu
    return param + (-lr) * ((mu / bc1) / (torch.sqrt(nu / bc2) + EPS)), mu, nu
