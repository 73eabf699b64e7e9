"""RGB-D sequences (counterpart of difusion_tpu/data/production.py:32-60,
205-340): the ``RGBDSequence`` iterator protocol yielding host-side numpy
``FrameData``, the analytic ``SyntheticSequence`` renderer that drives the
tests and the on-card smoke run without a dataset, and the mesh's error
against that analytic surface (:func:`mesh_error_stats`).
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from ..ops.imgproc import Intrinsic
from ..utils.motion import Isometry


class FrameData:
    """One RGB-D frame."""

    def __init__(self, rgb: np.ndarray, depth: np.ndarray, depth_ok: np.ndarray,
                 calib: Intrinsic, gt_pose: Optional[Isometry] = None,
                 frame_id: int = -1):
        self.rgb = rgb              # (H, W, 3) uint8, or f32 in [0, 1]
        self.depth = depth          # (H, W) uint16 raw units or f32 meters
        self.depth_ok = depth_ok    # (H, W) bool sensor validity
        self.calib = calib
        self.gt_pose = gt_pose
        self.frame_id = frame_id


class RGBDSequence:
    """Iterator protocol over :class:`FrameData`."""

    def __init__(self):
        self.frame_id = 0
        self.first_iso: Isometry = Isometry()
        self.gt_trajectory: Optional[List[Isometry]] = None

    def __iter__(self) -> Iterator[FrameData]:
        return self

    def __len__(self) -> int:
        raise NotImplementedError

    def __next__(self) -> FrameData:
        raise NotImplementedError


def surface_height(x: np.ndarray, y: np.ndarray,
                   corrugation: float = 0.1) -> np.ndarray:
    """The analytic surface ``z = 2 + a (sin 5x + 0.7 cos 4y)`` rendered by
    :class:`SyntheticSequence`."""
    return 2.0 + corrugation * (np.sin(5.0 * x) + 0.7 * np.cos(4.0 * y))


def mesh_error_stats(tris: np.ndarray, corrugation: float = 0.1) -> dict:
    """Mesh accuracy against the analytic surface: per-vertex distance to
    ``z = surface_height(x, y)``, first-order normalized by the local
    surface slope (|z error| / sqrt(1 + |grad h|^2)).  Returns mean / RMSE /
    95th percentile in meters and the vertex count."""
    v = np.asarray(tris, np.float64).reshape(-1, 3)
    if len(v) == 0:
        return {"mesh_err_mean": float("nan"), "mesh_err_rmse": float("nan"),
                "mesh_err_p95": float("nan"), "n_vertices": 0}
    a = corrugation
    dz = v[:, 2] - surface_height(v[:, 0], v[:, 1], a)
    gx = 5.0 * a * np.cos(5.0 * v[:, 0])
    gy = -2.8 * a * np.sin(4.0 * v[:, 1])
    dist = np.abs(dz) / np.sqrt(1.0 + gx * gx + gy * gy)
    return {"mesh_err_mean": float(dist.mean()),
            "mesh_err_rmse": float(np.sqrt((dist ** 2).mean())),
            "mesh_err_p95": float(np.percentile(dist, 95)),
            "n_vertices": int(len(v))}


class SyntheticSequence(RGBDSequence):
    """Analytic corrugated surface ``z = 2 + a (sin 5x + 0.7 cos 4y)`` with a
    world-x/y texture, seen along the JAX package's smooth ``"drift"``
    trajectory (a wander over fresh surface): deterministic, noise-free
    RGB-D with exact GT poses."""

    def __init__(self, n_frames: int = 100, h: int = 480, w: int = 640,
                 calib: Optional[Intrinsic] = None, corrugation: float = 0.1,
                 motion_scale: float = 1.0):
        super().__init__()
        self.n_frames = n_frames
        self.h, self.w = h, w
        self.calib = calib or Intrinsic(481.2, 480.0, (w - 1) / 2.0,
                                        (h - 1) / 2.0, 5000.0)
        self.corrugation = corrugation
        poses, pose = [], Isometry()
        for k in range(n_frames):
            poses.append(pose)
            twist = motion_scale * np.array([
                0.012 * np.sin(k / 9.0), 0.010 * np.cos(k / 7.0), 0.008,
                0.004 * np.sin(k / 5.0), 0.004 * np.cos(k / 6.0), 0.003,
            ]) * np.array([1, 1, np.sin(k / 15.0), 1, 1, 1])
            pose = pose.dot(Isometry.from_twist(twist))
        self.gt_trajectory = poses
        self.first_iso = poses[0]

    def __len__(self):
        return self.n_frames

    def render(self, pose: Isometry):
        uu, vv = np.meshgrid(np.arange(self.w), np.arange(self.h))
        rays = np.stack([(uu - self.calib.cx) / self.calib.fx,
                         (vv - self.calib.cy) / self.calib.fy,
                         np.ones_like(uu, np.float64)], axis=-1)
        dirs_w = rays @ pose.q.rotation_matrix.T
        t = pose.t
        a = self.corrugation

        def relief(x, y):
            return a * (np.sin(5.0 * x) + 0.7 * np.cos(4.0 * y))

        # fixed-point ray/surface intersection
        s = (2.0 - t[2]) / dirs_w[..., 2]
        for _ in range(30):
            p = t[None, None] + s[..., None] * dirs_w
            s = (2.0 + relief(p[..., 0], p[..., 1]) - t[2]) / dirs_w[..., 2]
        ok = s > 0.1
        depth = np.where(ok, s, 0.0).astype(np.float32)
        pts = t[None, None] + s[..., None] * dirs_w
        tex = (0.5 + 0.25 * np.sin(pts[..., 0] * 17.0)
               + 0.25 * np.cos(pts[..., 1] * 13.0))
        rgb = np.repeat((np.clip(tex, 0, 1) * 255).astype(np.uint8)[..., None],
                        3, -1)
        return rgb, depth, ok

    def __next__(self) -> FrameData:
        if self.frame_id >= len(self):
            raise StopIteration
        pose = self.gt_trajectory[self.frame_id]
        rgb, depth, ok = self.render(pose)
        depth = np.clip(depth * self.calib.dcam_scale, 0, 65535).astype(np.uint16)
        fd = FrameData(rgb, depth, ok, self.calib, pose, self.frame_id)
        self.frame_id += 1
        return fd
