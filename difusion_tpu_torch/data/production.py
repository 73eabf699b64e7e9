"""RGB-D sequences (counterpart of difusion_tpu/data/production.py): the
``RGBDSequence`` iterator protocol yielding host-side numpy ``FrameData``,
the ICL-NUIM and ScanNet loaders, the analytic ``SyntheticSequence``
renderer (trajectories ``drift``, ``loop`` and ``out_back``) that drives the
tests, the accuracy runs and the on-card smoke run without a dataset, the mesh's error against that analytic surface
(:func:`mesh_error_stats`), and :func:`open_sequence`.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from ..ops.imgproc import Intrinsic
from ..utils.motion import Isometry, Quaternion


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


def _imread_color(path: str) -> np.ndarray:
    # kept uint8: frames upload to the device at 1/4 the bytes and convert there
    if path.lower().endswith(".png"):
        from . import native_io
        if native_io.native_available():
            try:
                img = native_io.read_png(path)
                return img[:, :, :3] if img.ndim == 3 else \
                    np.repeat(img[:, :, None].astype(np.uint8), 3, axis=2)
            except ValueError:
                pass   # unsupported PNG variant -> cv2
    import cv2
    img = cv2.imread(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _imread_depth_raw(path: str) -> np.ndarray:
    if path.lower().endswith(".png"):
        from . import native_io
        if native_io.native_available():
            try:
                return native_io.read_png(path).astype(np.float32)
            except ValueError:
                pass
    import cv2
    return cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32)


class ICLNUIMSequence(RGBDSequence):
    """ICL-NUIM loader (reference icl_nuim.py:10-77): calib fixed at
    [481.2, 480.0, 319.5, 239.5, 5000], depth png / 5000 -> meters."""

    CALIB = Intrinsic(481.2, 480.0, 319.50, 239.50, 5000.0)

    def __init__(self, path: str, start_frame: int = 0, end_frame: int = -1,
                 first_tq: Optional[list] = None, load_gt: bool = False):
        super().__init__()
        self.calib = self.CALIB
        self.path = Path(path)
        self.color_names = sorted(
            [f"rgb/{t}" for t in os.listdir(self.path / "rgb")],
            key=lambda t: int(t[4:].split(".")[0]))
        self.depth_names = [f"depth/{t}.png" for t in range(len(self.color_names))]
        if first_tq is not None:
            self.first_iso = Isometry(q=Quaternion(array=np.asarray(first_tq[3:])),
                                      t=np.array(first_tq[:3]))
        else:
            self.first_iso = Isometry(q=Quaternion(array=np.array([0.0, -1.0, 0.0, 0.0])))
        if end_frame == -1:
            end_frame = len(self.color_names)
        self.color_names = self.color_names[start_frame:end_frame]
        self.depth_names = self.depth_names[start_frame:end_frame]

        if load_gt:
            gt_path = (list(self.path.glob("*.freiburg"))
                       + list(self.path.glob("groundtruth.txt")))[0]
            traj = self._parse_traj_file(str(gt_path))[start_frame:end_frame]
            change_iso = self.first_iso.dot(traj[0].inv())
            self.gt_trajectory = [change_iso.dot(t) for t in traj]
            assert len(self.gt_trajectory) == len(self.color_names)

    @staticmethod
    def _parse_traj_file(traj_path: str) -> List[Isometry]:
        """TUM-freiburg trajectory with the reference's y-flip + 180-deg-z
        canonicalization (icl_nuim.py:38-51)."""
        camera_ext = {}
        traj_data = np.atleast_2d(np.genfromtxt(traj_path))
        cano_quat = Isometry(q=Quaternion(axis=np.array([0.0, 0.0, 1.0]), degrees=180.0))
        for cur_p in traj_data:
            cur_q = Quaternion(w=cur_p[-1], x=cur_p[4], y=cur_p[5], z=cur_p[6]).rotation_matrix
            cur_t = cur_p[1:4].copy()
            cur_q[1] = -cur_q[1]
            cur_q[:, 1] = -cur_q[:, 1]
            cur_t[1] = -cur_t[1]
            camera_ext[int(cur_p[0])] = cano_quat.dot(
                Isometry.from_matrix(cur_q, cur_t))
        camera_ext[0] = camera_ext.get(0, camera_ext[1])
        return [camera_ext[t] for t in range(len(camera_ext))]

    def __len__(self):
        return len(self.color_names)

    def __next__(self) -> FrameData:
        if self.frame_id >= len(self):
            raise StopIteration
        # raw uint16 units: halves the upload and converts on device
        # (preprocess_frame divides by calib.dcam_scale)
        depth = _imread_depth_raw(str(self.path / self.depth_names[self.frame_id]))
        depth = depth.astype(np.uint16)
        rgb = _imread_color(str(self.path / self.color_names[self.frame_id]))
        ok = depth > 0
        gt = self.gt_trajectory[self.frame_id] if self.gt_trajectory else None
        fd = FrameData(rgb, depth, ok, self.CALIB, gt, self.frame_id)
        self.frame_id += 1
        return fd


class ScanNetSequence(RGBDSequence):
    """ScanNet sens-export loader: ``color/%d.jpg`` resized to the depth
    resolution, ``depth/%d.png`` in millimeters, ``pose/%d.txt`` 4x4
    camera-to-world, ``intrinsic/intrinsic_depth.txt``."""

    def __init__(self, path: str, start_frame: int = 0, end_frame: int = -1,
                 frame_skip: int = 1, load_gt: bool = True):
        super().__init__()
        self.path = Path(path)
        n = len(list((self.path / "depth").glob("*.png")))
        if end_frame == -1:
            end_frame = n
        self.ids = list(range(start_frame, end_frame, frame_skip))
        K = np.loadtxt(self.path / "intrinsic" / "intrinsic_depth.txt")
        self.calib = Intrinsic(float(K[0, 0]), float(K[1, 1]),
                                    float(K[0, 2]), float(K[1, 2]), 1000.0)
        if load_gt and (self.path / "pose").exists():
            self.gt_trajectory = []
            for i in self.ids:
                mat = np.loadtxt(self.path / "pose" / f"{i}.txt")
                self.gt_trajectory.append(Isometry.from_matrix(mat, ortho=True))
            self.first_iso = self.gt_trajectory[0]

    def __len__(self):
        return len(self.ids)

    def __next__(self) -> FrameData:
        import cv2
        if self.frame_id >= len(self):
            raise StopIteration
        i = self.ids[self.frame_id]
        depth = _imread_depth_raw(str(self.path / "depth" / f"{i}.png")).astype(np.uint16)
        rgb = _imread_color(str(self.path / "color" / f"{i}.jpg"))
        if rgb.shape[:2] != depth.shape:
            rgb = cv2.resize(rgb, (depth.shape[1], depth.shape[0]),
                             interpolation=cv2.INTER_AREA)
        ok = depth > 0
        gt = self.gt_trajectory[self.frame_id] if self.gt_trajectory else None
        fd = FrameData(rgb, depth, ok, self.calib, gt, i)
        self.frame_id += 1
        return fd


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
    world-x/y texture: deterministic, noise-free RGB-D with exact GT poses.

    ``trajectory`` selects the camera path:

    * ``"drift"`` (default): a smooth wander over fresh surface;
    * ``"loop"``: a closed circuit of radius ``motion_scale`` m, one lap
      over the sequence; its last ~20% re-enters territory mapped at the
      start, so tracking runs against an old map;
    * ``"out_back"``: straight out along +x for half the frames, then back;
      the second half tracks against the first half's map.

    ``seed`` is accepted as the JAX package accepts it; nothing is random."""

    def __init__(self, n_frames: int = 100, h: int = 480, w: int = 640,
                 calib: Optional[Intrinsic] = None, corrugation: float = 0.1,
                 motion_scale: float = 1.0, seed: int = 0,
                 trajectory: str = "drift"):
        super().__init__()
        self.n_frames = n_frames
        self.h, self.w = h, w
        self.calib = calib or Intrinsic(481.2, 480.0, (w - 1) / 2.0,
                                        (h - 1) / 2.0, 5000.0)
        self.corrugation = corrugation
        self.gt_trajectory = self._make_trajectory(trajectory, n_frames, motion_scale)
        self.first_iso = self.gt_trajectory[0]

    @staticmethod
    def _make_trajectory(kind: str, n_frames: int, motion_scale: float) -> List[Isometry]:
        poses = []
        if kind == "drift":
            pose = Isometry()
            for k in range(n_frames):
                poses.append(pose)
                twist = motion_scale * np.array([
                    0.012 * np.sin(k / 9.0), 0.010 * np.cos(k / 7.0), 0.008,
                    0.004 * np.sin(k / 5.0), 0.004 * np.cos(k / 6.0), 0.003,
                ]) * np.array([1, 1, np.sin(k / 15.0), 1, 1, 1])
                pose = pose.dot(Isometry.from_twist(twist))
        elif kind == "loop":
            R = motion_scale
            for k in range(n_frames):
                th = 2.0 * np.pi * k / n_frames
                t = np.array([R * np.sin(th), R * (1.0 - np.cos(th)),
                              0.05 * np.sin(3.0 * th)])
                # a gentle yaw/pitch sway exercises the rotation too
                q = (Quaternion(axis=[0, 0, 1], radians=0.15 * np.sin(2 * th))
                     * Quaternion(axis=[1, 0, 0], radians=0.08 * np.sin(th)))
                poses.append(Isometry(q=q, t=t))
        elif kind == "out_back":
            half = max(n_frames // 2, 1)
            step = 2.0 * motion_scale / half
            for k in range(n_frames):
                x = step * (k if k < half else (2 * half - k - 1))
                t = np.array([x, 0.1 * np.sin(0.5 * x), 0.0])
                q = Quaternion(axis=[0, 1, 0],
                               radians=0.06 * np.sin(2.0 * np.pi * k / half))
                poses.append(Isometry(q=q, t=t))
        else:
            raise ValueError(f"unknown trajectory {kind!r}")
        return poses

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

    def frame(self, k: int) -> FrameData:
        """Frame ``k``, rendered (u16 depth)."""
        pose = self.gt_trajectory[k]
        rgb, depth, ok = self.render(pose)
        depth = np.clip(depth * self.calib.dcam_scale, 0, 65535).astype(np.uint16)
        return FrameData(rgb, depth, ok, self.calib, pose, k)

    def __next__(self) -> FrameData:
        if self.frame_id >= len(self):
            raise StopIteration
        self.frame_id += 1
        return self.frame(self.frame_id - 1)


_SEQUENCE_TYPES = {
    "icl_nuim.ICLNUIMSequence": ICLNUIMSequence,
    "ICLNUIMSequence": ICLNUIMSequence,
    "scannet.ScanNetSequence": ScanNetSequence,
    "ScanNetSequence": ScanNetSequence,
    "synthetic.SyntheticSequence": SyntheticSequence,
    "SyntheticSequence": SyntheticSequence,
}


def open_sequence(sequence_type: str, **kwargs) -> RGBDSequence:
    """Resolve a reference-style ``sequence_type`` string (main.py:119-120)."""
    if sequence_type not in _SEQUENCE_TYPES:
        raise ValueError(f"unknown sequence_type {sequence_type!r}; "
                         f"known: {sorted(_SEQUENCE_TYPES)}")
    return _SEQUENCE_TYPES[sequence_type](**kwargs)
