"""Host-side SE(3)/SO(3) math in numpy: quaternions, isometries, ATE.

The port's own copy of the parts of difusion_tpu/utils/motion.py that the
track+fuse path, the sequence loaders and the sample generator use
(``Isometry`` with ``look_at`` and ``random``, ``Quaternion`` with
``random``, ``ate_rmse`` and the so(3) maps beneath them).  Conventions: quaternions are (w, x, y, z);
twists are ``xi = [rho, phi]`` (translation first).
"""
from __future__ import annotations

import numpy as np

_SMALL_ANGLE = 1e-6


def so3_wedge(phi: np.ndarray) -> np.ndarray:
    """Hat operator: (3,) -> (3, 3) skew-symmetric."""
    x, y, z = np.asarray(phi, np.float64)
    return np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])


def _sincc(angle: float, angle2: float):
    """(sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3) with Taylor limits."""
    if angle < _SMALL_ANGLE:
        return (1.0 - angle2 / 6.0, 0.5 - angle2 / 24.0,
                1.0 / 6.0 - angle2 / 120.0)
    s, c = np.sin(angle), np.cos(angle)
    return s / angle, (1.0 - c) / angle2, (angle - s) / (angle2 * angle)


def so3_exp(phi: np.ndarray) -> np.ndarray:
    phi = np.asarray(phi, np.float64)
    a2 = float(phi @ phi)
    c1, c2, _ = _sincc(np.sqrt(a2), a2)
    W = so3_wedge(phi)
    return np.eye(3) + c1 * W + c2 * (W @ W)


def so3_left_jacobian(phi: np.ndarray) -> np.ndarray:
    phi = np.asarray(phi, np.float64)
    a2 = float(phi @ phi)
    _, c1, c2 = _sincc(np.sqrt(a2), a2)
    W = so3_wedge(phi)
    return np.eye(3) + c1 * W + c2 * (W @ W)


def project_orthogonal(rot: np.ndarray) -> np.ndarray:
    u, _, vh = np.linalg.svd(rot, full_matrices=True)
    out = u @ vh
    if np.linalg.det(out) < 0:
        u[:, 2] = -u[:, 2]
        out = u @ vh
    return out


class Quaternion:
    """Minimal unit quaternion (w, x, y, z)."""

    __slots__ = ("q",)

    def __init__(self, w=1.0, x=0.0, y=0.0, z=0.0, *, array=None, axis=None,
                 degrees=None, radians=None, matrix=None):
        if array is not None:
            self.q = np.asarray(array, dtype=np.float64).copy()
        elif matrix is not None:
            self.q = self._from_matrix(np.asarray(matrix, dtype=np.float64))
        elif axis is not None:
            angle = np.deg2rad(degrees) if degrees is not None else (radians or 0.0)
            axis = np.asarray(axis, dtype=np.float64)
            axis = axis / np.linalg.norm(axis)
            half = 0.5 * angle
            self.q = np.concatenate([[np.cos(half)], np.sin(half) * axis])
        else:
            self.q = np.array([w, x, y, z], dtype=np.float64)

    @staticmethod
    def _from_matrix(m: np.ndarray) -> np.ndarray:
        if m.shape == (4, 4):
            m = m[:3, :3]
        # Shepperd's method: the largest diagonal combination for stability
        tr = np.trace(m)
        if tr > 0:
            s = np.sqrt(tr + 1.0) * 2
            q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                 (m[1, 0] - m[0, 1]) / s]
        elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
            s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
            q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
                 (m[0, 2] + m[2, 0]) / s]
        elif m[1, 1] > m[2, 2]:
            s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
            q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
                 (m[1, 2] + m[2, 1]) / s]
        else:
            s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
            q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                 (m[1, 2] + m[2, 1]) / s, 0.25 * s]
        q = np.array(q)
        return q / np.linalg.norm(q)

    @property
    def rotation_matrix(self) -> np.ndarray:
        w, x, y, z = self.q / np.linalg.norm(self.q)
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])

    @property
    def inverse(self) -> "Quaternion":
        conj = self.q * np.array([1.0, -1.0, -1.0, -1.0])
        return Quaternion(array=conj / (np.linalg.norm(self.q) ** 2))

    def __mul__(self, other: "Quaternion") -> "Quaternion":
        w1, x1, y1, z1 = self.q
        w2, x2, y2, z2 = other.q
        return Quaternion(
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        )

    def rotate(self, v: np.ndarray) -> np.ndarray:
        return self.rotation_matrix @ np.asarray(v, dtype=np.float64)

    @staticmethod
    def random(rng: np.random.Generator = None) -> "Quaternion":
        """Uniform over SO(3) (Shoemake's subgroup algorithm)."""
        r = (rng or np.random).random(3)
        s1, s2 = np.sqrt(1 - r[0]), np.sqrt(r[0])
        t1, t2 = 2 * np.pi * r[1], 2 * np.pi * r[2]
        return Quaternion(np.cos(t2) * s2, np.sin(t1) * s1, np.cos(t1) * s1,
                          np.sin(t2) * s2)

    def __repr__(self):
        return (f"Quaternion({self.q[0]:+.6f} {self.q[1]:+.6f}i "
                f"{self.q[2]:+.6f}j {self.q[3]:+.6f}k)")


class Isometry:
    """Rigid transform (q, t)."""

    def __init__(self, q: Quaternion = None, t=None):
        self.q = q if q is not None else Quaternion()
        t = np.zeros(3) if t is None else np.asarray(t, dtype=np.float64)
        if t.shape != (3,):
            raise ValueError(f"translation must have shape (3,), got {t.shape}")
        self.t = t

    def __repr__(self):
        return f"Isometry(q={self.q}, t={np.round(self.t, 6)})"

    @staticmethod
    def from_matrix(mat: np.ndarray, t_component=None, ortho=False) -> "Isometry":
        mat = np.asarray(mat, dtype=np.float64)
        if t_component is None:
            rot = project_orthogonal(mat[:3, :3]) if ortho else mat[:3, :3]
            return Isometry(q=Quaternion(matrix=rot), t=mat[:3, 3])
        rot = project_orthogonal(mat) if ortho else mat
        return Isometry(q=Quaternion(matrix=rot), t=np.asarray(t_component))

    @staticmethod
    def from_twist(xi: np.ndarray) -> "Isometry":
        rho, phi = np.asarray(xi)[:3], np.asarray(xi)[3:6]
        return Isometry(q=Quaternion(matrix=so3_exp(phi)),
                        t=so3_left_jacobian(phi) @ rho)

    @property
    def matrix(self) -> np.ndarray:
        out = np.eye(4)
        out[:3, :3] = self.q.rotation_matrix
        out[:3, 3] = self.t
        return out

    def inv(self) -> "Isometry":
        qinv = self.q.inverse
        return Isometry(q=qinv, t=-qinv.rotate(self.t))

    def dot(self, right: "Isometry") -> "Isometry":
        return Isometry(q=self.q * right.q, t=self.q.rotate(right.t) + self.t)

    @staticmethod
    def look_at(source: np.ndarray, target: np.ndarray, up: np.ndarray = None) -> "Isometry":
        """Camera pose at ``source`` whose +z axis points at ``target``; +y is
        the image-down direction derived from ``up``, which defaults to world
        +y with a +x fallback when the view direction is vertical."""
        eye = np.asarray(source, np.float64)
        fwd = np.asarray(target, np.float64) - eye
        fwd = fwd / np.linalg.norm(fwd)
        if up is None:
            up = np.array([0.0, 1.0, 0.0])
            if np.linalg.norm(np.cross(fwd, up)) < 1e-6:   # looking along +-y
                up = np.array([1.0, 0.0, 0.0])
        else:
            up = np.asarray(up, np.float64) / np.linalg.norm(up)
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        down = np.cross(fwd, right)
        basis = np.stack([right, down, fwd], axis=1)       # camera axes as columns
        return Isometry(q=Quaternion(matrix=basis), t=eye)

    @staticmethod
    def random(rng: np.random.Generator = None) -> "Isometry":
        return Isometry(q=Quaternion.random(rng), t=(rng or np.random).random(3))


def ate_rmse(gt: list, pred: list, align: bool = True) -> float:
    """Absolute trajectory error (RMSE over translation), with optional
    SE(3) (Umeyama, no scale) alignment."""
    gt_t = np.stack([p.t for p in gt])
    pd_t = np.stack([p.t for p in pred])
    if gt_t.shape != pd_t.shape:
        raise ValueError(f"trajectory shapes differ: {gt_t.shape} vs {pd_t.shape}")
    if align:
        mu_g, mu_p = gt_t.mean(0), pd_t.mean(0)
        gc, pc = gt_t - mu_g, pd_t - mu_p
        u, _, vh = np.linalg.svd(gc.T @ pc)
        S = np.eye(3)
        if np.linalg.det(u @ vh) < 0:
            S[2, 2] = -1
        pd_t = ((u @ S @ vh) @ pc.T).T + mu_g
    err = gt_t - pd_t
    return float(np.sqrt((err ** 2).sum(-1).mean()))
