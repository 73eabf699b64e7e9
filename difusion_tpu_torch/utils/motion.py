"""Host-side SE(3)/SO(3) math in numpy: quaternions, isometries, Lie-algebra
maps, ATE.

The port's own copy of difusion_tpu/utils/motion.py, the whole of it: the
so(3)/se(3) maps (exp, log, left Jacobians and their inverses, the
curly-wedge), ``Quaternion`` (log/exp, slerp) and ``Isometry`` (twists,
adjoint, interpolation, the GL camera convention, the 9/12-float
representations), float64 numpy throughout.  ``Isometry @ x`` applies the
transform to numpy arrays and to torch tensors, on the tensor's own device
and dtype.  The in-graph twist math of the tracker is :mod:`..ops.se3`.

Conventions: quaternions are (w, x, y, z), unit-norm for rotations; twists
are ``xi = [rho, phi]`` (translation first).
"""
from __future__ import annotations

import numpy as np
import torch

# Every map is the coefficient-series form ``I + c1(t) W + c2(t) W^2`` over
# the wedge matrix W, with Taylor limits below _SMALL_ANGLE, so it is smooth
# through t -> 0; the log goes through the quaternion, stable up to t = pi.
_SMALL_ANGLE = 1e-6


def so3_wedge(phi: np.ndarray) -> np.ndarray:
    """Hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    phi = np.asarray(phi, np.float64)
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    o = np.zeros_like(x)
    rows = [np.stack([o, -z, y], axis=-1),
            np.stack([z, o, -x], axis=-1),
            np.stack([-y, x, o], axis=-1)]
    return np.stack(rows, axis=-2)


def so3_vee(Phi: np.ndarray) -> np.ndarray:
    """Inverse hat operator: (..., 3, 3) -> (..., 3)."""
    Phi = np.asarray(Phi)
    return np.stack([Phi[..., 2, 1], Phi[..., 0, 2], Phi[..., 1, 0]], axis=-1)


def _sincc(angle: float, angle2: float):
    """(sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3) with Taylor limits."""
    if angle < _SMALL_ANGLE:
        return (1.0 - angle2 / 6.0, 0.5 - angle2 / 24.0,
                1.0 / 6.0 - angle2 / 120.0)
    s, c = np.sin(angle), np.cos(angle)
    return s / angle, (1.0 - c) / angle2, (angle - s) / (angle2 * angle)


def so3_exp(phi: np.ndarray) -> np.ndarray:
    """Exponential map: R = I + sinc(t) W + cosc(t) W^2."""
    phi = np.asarray(phi, np.float64)
    a2 = float(phi @ phi)
    c1, c2, _ = _sincc(np.sqrt(a2), a2)
    W = so3_wedge(phi)
    return np.eye(3) + c1 * W + c2 * (W @ W)


def so3_log(R: np.ndarray) -> np.ndarray:
    """Log map via the quaternion: phi = 2 atan2(|v|, w) v/|v|, which stays
    well-conditioned near t = pi where the trace/skew formula does not."""
    q = Quaternion(matrix=np.asarray(R, np.float64))
    w, v = q.w, q.vector
    if w < 0.0:                      # canonical hemisphere
        w, v = -w, -v
    vn = np.linalg.norm(v)
    if vn < 1e-12:
        return 2.0 * v / max(w, 1e-12)
    return (2.0 * np.arctan2(vn, w)) * (v / vn)


def so3_left_jacobian(phi: np.ndarray) -> np.ndarray:
    """J_l = I + cosc(t) W + (t - sin t)/t^3 W^2."""
    phi = np.asarray(phi, np.float64)
    a2 = float(phi @ phi)
    _, c1, c2 = _sincc(np.sqrt(a2), a2)
    W = so3_wedge(phi)
    return np.eye(3) + c1 * W + c2 * (W @ W)


def so3_inv_left_jacobian(phi: np.ndarray) -> np.ndarray:
    """J_l^-1 = I - W/2 + k(t) W^2,  k = 1/t^2 - (1 + cos t)/(2 t sin t)."""
    phi = np.asarray(phi, np.float64)
    a2 = float(phi @ phi)
    angle = np.sqrt(a2)
    if angle < _SMALL_ANGLE:
        k = 1.0 / 12.0 + a2 / 720.0
    else:
        k = 1.0 / a2 - (1.0 + np.cos(angle)) / (2.0 * angle * np.sin(angle))
    W = so3_wedge(phi)
    return np.eye(3) - 0.5 * W + k * (W @ W)


def se3_curlywedge(xi: np.ndarray) -> np.ndarray:
    """Adjoint-algebra matrix of a twist: [[W(phi), W(rho)], [0, W(phi)]]."""
    xi = np.asarray(xi, np.float64)
    Wp = so3_wedge(xi[..., 3:6])
    Wr = so3_wedge(xi[..., 0:3])
    top = np.concatenate([Wp, Wr], axis=-1)
    bot = np.concatenate([np.zeros_like(Wp), Wp], axis=-1)
    return np.concatenate([top, bot], axis=-2)


def _se3_translation_block(rho: np.ndarray, phi: np.ndarray) -> np.ndarray:
    """Upper-right block Q of the SE(3) left Jacobian (Barfoot, "State
    Estimation for Robotics", eq. 7.86b) from the commutator products of
    W(rho) and W(phi), with Taylor-stable coefficients."""
    a2 = float(phi @ phi)
    angle = np.sqrt(a2)
    _, _, c_sin3 = _sincc(angle, a2)           # (t - sin t)/t^3
    if angle < _SMALL_ANGLE:
        c4 = 1.0 / 24.0 - a2 / 720.0           # (t^2/2 + cos t - 1)/t^4
        c5 = 1.0 / 120.0 - a2 / 2520.0         # (t - 1.5 sin t + t cos t / 2)/t^5
    else:
        c4 = (0.5 * a2 + np.cos(angle) - 1.0) / (a2 * a2)
        c5 = (angle - 1.5 * np.sin(angle)
              + 0.5 * angle * np.cos(angle)) / (a2 * a2 * angle)
    R_ = so3_wedge(rho)
    P = so3_wedge(phi)
    PR, RP = P @ R_, R_ @ P
    PRP = PR @ P
    return (0.5 * R_
            + c_sin3 * (PR + RP + PRP)
            + c4 * (P @ PR + RP @ P - 3.0 * PRP)
            + c5 * (PRP @ P + P @ PRP))


def se3_left_jacobian(xi: np.ndarray) -> np.ndarray:
    xi = np.asarray(xi, np.float64)
    J = so3_left_jacobian(xi[3:6])
    Q = _se3_translation_block(xi[0:3], xi[3:6])
    return np.block([[J, Q], [np.zeros((3, 3)), J]])


def se3_inv_left_jacobian(xi: np.ndarray) -> np.ndarray:
    xi = np.asarray(xi, np.float64)
    Ji = so3_inv_left_jacobian(xi[3:6])
    Q = _se3_translation_block(xi[0:3], xi[3:6])
    return np.block([[Ji, -Ji @ Q @ Ji], [np.zeros((3, 3)), Ji]])


def project_orthogonal(rot: np.ndarray) -> np.ndarray:
    u, _, vh = np.linalg.svd(rot, full_matrices=True)
    out = u @ vh
    if np.linalg.det(out) < 0:
        u[:, 2] = -u[:, 2]
        out = u @ vh
    return out


class Quaternion:
    """Minimal quaternion (w, x, y, z); unit-norm for rotations."""

    __slots__ = ("q",)

    def __init__(self, w=1.0, x=0.0, y=0.0, z=0.0, *, array=None, axis=None,
                 degrees=None, radians=None, matrix=None, imaginary=None, real=None):
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
        elif imaginary is not None:
            self.q = np.concatenate([[float(real)],
                                     np.asarray(imaginary, dtype=np.float64)])
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

    # -- accessors ------------------------------------------------------------
    @property
    def w(self):
        return self.q[0]

    @property
    def vector(self):
        return self.q[1:]

    @property
    def elements(self):
        return self.q

    @property
    def norm(self):
        return np.linalg.norm(self.q)

    @property
    def normalised(self) -> "Quaternion":
        return Quaternion(array=self.q / self.norm)

    @property
    def inverse(self) -> "Quaternion":
        return Quaternion(array=self.conjugate.q / (self.norm ** 2))

    @property
    def conjugate(self) -> "Quaternion":
        return Quaternion(array=self.q * np.array([1.0, -1.0, -1.0, -1.0]))

    @property
    def rotation_matrix(self) -> np.ndarray:
        w, x, y, z = self.q / self.norm
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])

    @property
    def transformation_matrix(self) -> np.ndarray:
        out = np.eye(4)
        out[:3, :3] = self.rotation_matrix
        return out

    # -- algebra --------------------------------------------------------------
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

    def __repr__(self):
        return (f"Quaternion({self.q[0]:+.6f} {self.q[1]:+.6f}i "
                f"{self.q[2]:+.6f}j {self.q[3]:+.6f}k)")

    # -- exponential map ------------------------------------------------------
    @staticmethod
    def log(q: "Quaternion") -> "Quaternion":
        qn = q.normalised
        v_norm = np.linalg.norm(qn.vector)
        if v_norm < 1e-12:
            return Quaternion(0.0, 0.0, 0.0, 0.0)
        angle = np.arctan2(v_norm, qn.w)
        return Quaternion(array=np.concatenate([[0.0], angle * qn.vector / v_norm]))

    @staticmethod
    def exp(q: "Quaternion") -> "Quaternion":
        v = q.vector
        v_norm = np.linalg.norm(v)
        w = np.exp(q.w)
        if v_norm < 1e-12:
            return Quaternion(array=np.array([w, 0.0, 0.0, 0.0]))
        return Quaternion(array=w * np.concatenate([[np.cos(v_norm)],
                                                    np.sin(v_norm) * v / v_norm]))

    @staticmethod
    def random(rng: np.random.Generator = None) -> "Quaternion":
        """Uniform over SO(3) (Shoemake's subgroup algorithm)."""
        r = (rng or np.random).random(3)
        s1, s2 = np.sqrt(1 - r[0]), np.sqrt(r[0])
        t1, t2 = 2 * np.pi * r[1], 2 * np.pi * r[2]
        return Quaternion(np.cos(t2) * s2, np.sin(t1) * s1, np.cos(t1) * s1,
                          np.sin(t2) * s2)

    @staticmethod
    def slerp(q0: "Quaternion", q1: "Quaternion", amount: float) -> "Quaternion":
        """Spherical interpolation along the shorter arc (linear, then
        normalised, where the two are within ~1.8 degrees)."""
        a, b = q0.normalised.q, q1.normalised.q
        dot = float(np.dot(a, b))
        if dot < 0.0:
            b, dot = -b, -dot
        if dot > 0.9995:
            out = a + amount * (b - a)
            return Quaternion(array=out / np.linalg.norm(out))
        theta0 = np.arccos(dot)
        theta = theta0 * amount
        s0 = np.cos(theta) - dot * np.sin(theta) / np.sin(theta0)
        s1 = np.sin(theta) / np.sin(theta0)
        return Quaternion(array=s0 * a + s1 * b)


class Isometry:
    """Rigid transform (q, t): the reference's ``Isometry`` operations
    (pytorch/utils/motion_util.py:162-339), names and the 9/12-float
    interchange layouts included."""

    GL_POST_MULT: "Quaternion"

    def __init__(self, q: Quaternion = None, t=None):
        self.q = q if q is not None else Quaternion()
        t = np.zeros(3) if t is None else np.asarray(t, dtype=np.float64)
        if t.shape != (3,):
            raise ValueError(f"translation must have shape (3,), got {t.shape}")
        self.t = t

    def __repr__(self):
        return f"Isometry(q={self.q}, t={np.round(self.t, 6)})"

    @property
    def rotation(self) -> "Isometry":
        return Isometry(q=self.q)

    @property
    def matrix(self) -> np.ndarray:
        out = self.q.transformation_matrix
        out[:3, 3] = self.t
        return out

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

    @staticmethod
    def from_so3_exp(phi: np.ndarray) -> "Isometry":
        return Isometry(q=Quaternion(matrix=so3_exp(phi)))

    def log(self) -> np.ndarray:
        """The twist [rho, phi] whose exponential is this transform."""
        phi = so3_log(self.q.rotation_matrix)
        return np.hstack([so3_inv_left_jacobian(phi) @ self.t, phi])

    def adjoint_matrix(self) -> np.ndarray:
        R = self.q.rotation_matrix
        out = np.zeros((6, 6))
        out[0:3, 0:3] = R
        out[3:6, 3:6] = R
        out[0:3, 3:6] = so3_wedge(self.t) @ R
        return out

    def inv(self) -> "Isometry":
        qinv = self.q.inverse
        return Isometry(q=qinv, t=-qinv.rotate(self.t))

    def dot(self, right: "Isometry") -> "Isometry":
        return Isometry(q=self.q * right.q, t=self.q.rotate(right.t) + self.t)

    def to_gl_camera(self) -> "Isometry":
        return Isometry(q=self.q * Isometry.GL_POST_MULT, t=self.t)

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

    @staticmethod
    def interpolate(source: "Isometry", target: "Isometry", alpha: float) -> "Isometry":
        return Isometry(q=Quaternion.slerp(source.q, target.q, alpha),
                        t=source.t * (1 - alpha) + target.t * alpha)

    def tangent(self, prev_iso: "Isometry", next_iso: "Isometry") -> "Isometry":
        """Trajectory tangent at this pose from its two neighbours: the
        central-difference velocity for translation; for rotation, exp of -1/4
        the summed logs of the relative rotations to each neighbour (the
        reference's spline tangent for camera-rig smoothing)."""
        vel = (next_iso.t - prev_iso.t) / 2.0
        here_inv = self.q.inverse
        logs = sum(Quaternion.log((here_inv * nb.q).normalised).q
                   for nb in (prev_iso, next_iso))
        spin = Quaternion.exp(Quaternion(array=logs * -0.25))
        return Isometry(q=self.q * spin, t=vel)

    # -- 9 / 12-float representations: two rotation columns + t; the rotation
    # column-major + t ---------------------------------------------------------
    @property
    def continuous_repr(self) -> np.ndarray:
        R = self.q.rotation_matrix
        return np.concatenate([R[:, 0], R[:, 1], self.t])

    @staticmethod
    def from_continuous_repr(rep, gs=True) -> "Isometry":
        rep = np.asarray(rep, dtype=np.float64)
        if rep.shape != (9,):
            raise ValueError(f"a continuous representation has 9 floats, got {rep.shape}")
        a, b = rep[0:3], rep[3:6]
        if gs:     # Gram-Schmidt the first two columns
            a = a / np.linalg.norm(a)
            b = b - (a @ b) * a
            b = b / np.linalg.norm(b)
        R = np.stack([a, b, np.cross(a, b)], axis=1)
        return Isometry(q=Quaternion(matrix=R), t=rep[6:9])

    @property
    def full_repr(self) -> np.ndarray:
        return np.concatenate([self.q.rotation_matrix.flatten(order="F"), self.t])

    @staticmethod
    def from_full_repr(rep: np.ndarray, ortho=False) -> "Isometry":
        rep = np.asarray(rep, dtype=np.float64)
        if rep.shape != (12,):
            raise ValueError(f"a full representation has 12 floats, got {rep.shape}")
        rot = rep[0:9].reshape(3, 3, order="F")
        if ortho:
            rot = project_orthogonal(rot)
        return Isometry(q=Quaternion(matrix=rot), t=rep[9:12])

    # -- application ----------------------------------------------------------
    def __matmul__(self, other):
        """Compose with another Isometry, or apply to points: (N, 3) or (3,)
        numpy arrays, or (N, 3) torch tensors, which stay on their device
        and dtype (R.T and t are cast to them)."""
        if isinstance(other, Isometry):
            return self.dot(other)
        R = self.q.rotation_matrix
        if isinstance(other, torch.Tensor):
            if other.ndim != 2:
                raise ValueError(f"points tensor must be (N, 3), got {tuple(other.shape)}")
            kw = dict(dtype=other.dtype, device=other.device)
            return other @ torch.as_tensor(R.T, **kw) + torch.as_tensor(self.t, **kw)
        if hasattr(other, "ndim") and other.ndim == 2:
            return np.asarray(other) @ R.T + self.t[None, :]
        return R @ np.asarray(other) + self.t


Isometry.GL_POST_MULT = Quaternion(axis=[1.0, 0.0, 0.0], degrees=180.0)


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
