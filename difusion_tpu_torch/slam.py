"""Online SLAM on the dense map: track + fuse + mesh (counterpart of
difusion_tpu/slam.py:142-360 and 551-552, per-frame path, no latent
optimization).

Per frame: ``SDFTracker.track_camera_packed`` (the first frame takes its
given pose); every ``integrate_interval`` frames ``integrate_keyframe``
with the tracked pose applied to the frame's point cloud; and every
``meshing_interval`` frames (by default the integrate interval) a
synchronous incremental mesh extract.  The JAX package can also run K frames
as one ``lax.scan`` dispatch and mesh in a worker thread; the port runs the
same per-frame program in a Python loop.
"""
from __future__ import annotations

from typing import Optional

import torch

from .core import map as M
from .core import tracker as tracker_mod
from .core.meshing import MeshExtractor
from .core.tracker import SDFTracker, TrackerConfig
from .data.production import FrameData
from .device import resolve_device
from .models.decoder import Decoder
from .models.encoder import Encoder
from .models.weights import load_prior
from .ops.imgproc import Intrinsic
from .ops.se3 import Pose
from .utils.motion import Isometry

__all__ = ["SLAMSystem", "load_prior"]


class SLAMSystem:
    """Track + fuse + mesh over an RGB-D stream on ``device`` (``"cuda"``
    unless the caller asks for ``"cpu"``)."""

    def __init__(self, map_cfg: M.MapConfig, tcfg: TrackerConfig,
                 decoder: Decoder, encoder: Encoder, calib: Intrinsic,
                 integrate_interval: int = 20,
                 depth_cut: tuple = (0.5, 5.0),
                 mesh_resolution: int = 4,
                 max_triangles: int = 1 << 22,
                 mesh_max_std: float = 0.15,
                 mesh_fast: bool = False,
                 meshing: bool = True,
                 meshing_interval: int = -1,
                 run_async: bool = False,
                 latent_optimize: bool = False,
                 device="cuda"):
        if mesh_fast:
            raise NotImplementedError(
                "mesh_fast=True is not ported yet: it needs the coarse-to-fine "
                "lattice decode (_eval_and_negate_fast)")
        if run_async:
            raise NotImplementedError("run_async (meshing in a worker thread) "
                                      "is not ported yet")
        if latent_optimize:
            raise NotImplementedError("latent optimization is not ported yet")
        self.device = resolve_device(device)
        self.map_cfg = map_cfg
        self.decoder = decoder.to(self.device)
        self.encoder = encoder.to(self.device)
        self.state = M.create_map_state(map_cfg, self.device)
        tcfg = tcfg._replace(depth_cut_min=float(depth_cut[0]),
                             depth_cut_max=float(depth_cut[1]))
        self.tracker = SDFTracker(map_cfg, tcfg, self.decoder, calib,
                                  self.device)
        self.integrate_interval = integrate_interval
        self.mesher = MeshExtractor(map_cfg, self.decoder,
                                    voxel_resolution=mesh_resolution,
                                    max_triangles=max_triangles) if meshing else None
        self.meshing_interval = (meshing_interval if meshing_interval > 0
                                 else integrate_interval)
        self.mesh_max_std = mesh_max_std
        self.first_iso: Optional[Isometry] = None

    def process_frame(self, frame: FrameData,
                      packed: Optional[torch.Tensor] = None) -> Pose:
        """Track (and on schedule fuse and mesh) one frame.
        Returns the device pose.  ``packed``: optionally the frame's
        :func:`~.core.tracker.pack_frame` buffer already on the device."""
        set_pose = None
        if self.tracker.n_tracked == 0:
            set_pose = self.first_iso if self.first_iso is not None else (
                frame.gt_pose if frame.gt_pose is not None else Isometry())
        tr = self.tracker
        if packed is None:
            packed = torch.from_numpy(tracker_mod.pack_frame(
                frame.rgb, frame.depth, tr.calib.dcam_scale,
                lossless=tr.tcfg.lossless_packing)).to(self.device)
        pose = tr.track_camera_packed(self.state, packed, frame.depth.shape[1],
                                      set_pose)
        if (tr.n_tracked - 1) % self.integrate_interval == 0:
            w_pts, w_nrm, w_mask = tr.last_pc_world(pose)
            self.state = M.integrate_keyframe(self.map_cfg, self.encoder,
                                              self.state, w_pts, w_nrm, w_mask)
        if self.mesher is not None and (tr.n_tracked - 1) % self.meshing_interval == 0:
            self.state = self.mesher.extract(self.state, max_std=self.mesh_max_std)
        return pose

    def save_map(self, path) -> None:
        """Write the map in the JAX package's npz format."""
        M.save_map(path, self.map_cfg, self.state)
