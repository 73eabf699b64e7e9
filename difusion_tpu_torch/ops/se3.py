"""SE(3) math on tensors (counterpart of difusion_tpu/ops/se3.py).

Poses are (R, t) pairs of (3, 3) and (3,) tensors; twists are
``xi = [rho, phi]`` (translation first), matching :mod:`..utils.motion`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Pose(NamedTuple):
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        """(N, 3) -> (N, 3)."""
        return pts @ self.R.T + self.t[None, :]

    def compose(self, other: "Pose") -> "Pose":
        """``self`` after ``other``: (R1 R2, R1 t2 + t1)."""
        return Pose(self.R @ other.R, self.R @ other.t + self.t)

    def inv(self) -> "Pose":
        Rt = self.R.T
        return Pose(Rt, -(Rt @ self.t))

    @staticmethod
    def identity(device=None, dtype=torch.float32) -> "Pose":
        return Pose(torch.eye(3, dtype=dtype, device=device),
                    torch.zeros(3, dtype=dtype, device=device))


def so3_wedge(phi: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=phi.dtype, device=phi.device)
    return torch.stack([
        torch.stack([z, -phi[2], phi[1]]),
        torch.stack([phi[2], z, -phi[0]]),
        torch.stack([-phi[1], phi[0], z]),
    ])


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with a Taylor branch near zero (branchless)."""
    angle2 = torch.dot(phi, phi)
    angle = torch.sqrt(angle2 + 1e-32)
    W = so3_wedge(phi)
    small = angle < 1e-5
    sinc = torch.where(small, 1.0 - angle2 / 6.0, torch.sin(angle) / angle)
    cosc = torch.where(small, 0.5 - angle2 / 24.0,
                       (1.0 - torch.cos(angle)) / angle2)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + sinc * W + cosc * (W @ W)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """J = I + (1-cos a)/a^2 W + (a - sin a)/a^3 W^2."""
    angle2 = torch.dot(phi, phi)
    angle = torch.sqrt(angle2 + 1e-32)
    W = so3_wedge(phi)
    small = angle < 1e-5
    c1 = torch.where(small, 0.5 - angle2 / 24.0,
                     (1.0 - torch.cos(angle)) / angle2)
    c2 = torch.where(small, 1.0 / 6.0 - angle2 / 120.0,
                     (angle - torch.sin(angle)) / (angle2 * angle))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + c1 * W + c2 * (W @ W)


def exp_twist(xi: torch.Tensor) -> Pose:
    """se(3) exponential: xi = [rho, phi] -> Pose (``Isometry.from_twist``)."""
    rho, phi = xi[:3], xi[3:6]
    return Pose(so3_exp(phi), so3_left_jacobian(phi) @ rho)
