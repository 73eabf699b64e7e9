"""Lattice sample generation (counterpart of difusion_tpu/ops/sampling.py).

The arithmetic is numpy f32, exactly as the JAX package does it, so the
lattices are bit-equal; callers upload them once per device.
"""
from __future__ import annotations

import numpy as np


def get_samples(r: int, a: float = 0.0, b: float = None) -> np.ndarray:
    """(r^3, 3) f32 lattice over [a, b]^3, x-major order, step (b-a)/(r-1)."""
    if b is None:
        b = 1.0 - 1.0 / r
    idx = np.arange(r ** 3)
    vsize = (b - a) / (r - 1)
    return np.stack([
        (idx // (r * r)) * vsize + a,
        ((idx // r) % r) * vsize + a,
        (idx % r) * vsize + a,
    ], axis=1).astype(np.float32)


def block_lattice(r: int) -> np.ndarray:
    """The (2r)^3 meshing lattice in voxel-center-relative coordinates: spans
    a half-voxel margin on each side."""
    sample_a = -(r // 2) * (1.0 / r)
    sample_b = 1.0 + ((r - 1) // 2) * (1.0 / r)
    return get_samples(2 * r, a=sample_a, b=sample_b) - np.float32(0.5)
