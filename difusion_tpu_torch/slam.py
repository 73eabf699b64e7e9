"""Online SLAM: track + fuse + mesh, and the offline runner
``python -m difusion_tpu_torch.slam <fusion yaml>`` (counterpart of
difusion_tpu/slam.py, without latent optimization, the interactive
step-through and the profiler trace).

The map is the dense one (``core/map.py``) when the mapping config gives
bounds, else (or with ``indexer: hash``) the hash-indexed one
(``core/hash_map.py``).  Per frame: ``SDFTracker.track_camera_packed`` (the
first frame takes its given pose); every ``integrate_interval`` frames
``integrate_keyframe`` with the tracked pose applied to the frame's point
cloud; and every ``meshing_interval`` frames (by default the integrate
interval) a synchronous incremental mesh extract.

Two paths run that program.  :meth:`SLAMSystem.process_frame` tracks one
frame at a time, :func:`track_fuse_scan` / :meth:`SLAMSystem.process_chunk`
K frames from one stacked upload, with fusion between frames on those the
schedule names.  On the card both track each frame as one launch of the
tracker's :class:`~.core.tracker.TrackProgram` (a CUDA graph whose GN loops
end on the device), so the host reads no exit flag; on the CPU the
per-frame path runs the host loop.  Both compute the same values.
"""
from __future__ import annotations

import json
import logging
import queue
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import apply_override, dict_to_args, load_yaml_args
from .core import hash_map as HM
from .core import map as M
from .core import tracker as tracker_mod
from .core.meshing import HashMeshExtractor, MeshExtractor
from .core.tracker import ProcessedFrame, SDFTracker, TrackerConfig
from .data.production import FrameData, RGBDSequence, open_sequence
from .device import resolve_device
from .models.decoder import Decoder
from .models.encoder import Encoder
from .models.weights import load_prior
from .ops.imgproc import Intrinsic, Pyramid
from .ops.se3 import Pose
from .utils.motion import Isometry, ate_rmse

__all__ = ["SLAMSystem", "load_prior", "track_fuse_scan"]

_PointCloud = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class ScanCarry(NamedTuple):
    """What :func:`track_fuse_scan` leaves behind (the JAX scan's carry).
    All but ``state`` and ``integrated`` are the tracker program's own
    tensors: the next chunk rewrites them."""
    state: Any                       # M.MapState or HM.HashMapState
    last: Pose
    pyramid: Pyramid
    rgb_weight: torch.Tensor
    n_unstable: torch.Tensor
    delta: Pose
    processed: ProcessedFrame        # the chunk's last frame
    integrated: _PointCloud          # the last fused frame's world-space cloud


def track_fuse_scan(tracker: SDFTracker, encoder: Encoder, state: M.MapState,
                    packed_chunk: torch.Tensor, do_integrate: Sequence[bool],
                    w: int, merge_at=None, merge_args=None,
                    with_merge: bool = False):
    """K sequential frame steps (unpack + preprocess + GN track + optional
    encoder fusion) from one stacked buffer, starting from ``tracker``'s
    temporal state (which it does not change: see
    :meth:`SLAMSystem.process_chunk`).

    ``packed_chunk``: (K, h, 3w) stacked :func:`~.core.tracker.pack_frame`
    buffers on the device ((K, h, 16w) for the lossless packing).
    ``do_integrate``: K host bools -- fuse that frame's point cloud after
    tracking it.  The schedule is known on the host, so fusion needs no
    device-side branch.  Returns ``(ScanCarry, (Rs (K, 3, 3), ts (K, 3),
    energies (K,)))``.  Numerically identical to K ``process_frame`` calls."""
    if with_merge or merge_at is not None or merge_args is not None:
        raise NotImplementedError(
            "with_merge folds a latent-optimizer result into the map; latent "
            "optimization is not ported yet (ROADMAP.md, 'Next, in order': "
            "latent optimisation with with_merge)")
    K = int(packed_chunk.shape[0])
    dev = packed_chunk.device
    integrate = HM.map_module(tracker.map_cfg).integrate_keyframe
    prog = tracker.program(packed_chunk.shape[1:], w)
    prog.load_state(state)
    outs = torch.empty(K, 13, device=dev)
    budget = tracker.tcfg.point_budget
    integrated = (torch.zeros(budget, 3, device=dev), torch.zeros(budget, 3, device=dev),
                  torch.zeros(budget, dtype=torch.bool, device=dev))
    for k in range(K):
        prog.preprocess_and_track(packed_chunk[k])
        outs[k].copy_(prog.out)
        if do_integrate[k]:
            state = integrate(tracker.map_cfg, encoder, state, *prog.world)
            prog.load_state(state)
            integrated = tuple(t.clone() for t in prog.world)
    carry = ScanCarry(state, prog.last, prog.prev, prog.rgb_weight, prog.n_unstable,
                      prog.delta, prog.cur._replace(pyramid=prog.prev), integrated)
    return carry, (outs[:, :9].reshape(K, 3, 3), outs[:, 9:12], outs[:, 12])


class SLAMSystem:
    """Track + fuse + mesh over an RGB-D stream on ``device`` (``"cuda"``
    unless the caller asks for ``"cpu"``)."""

    def __init__(self, map_cfg, tcfg: TrackerConfig,
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
                 profile: bool = False,
                 latent_optimize: bool = False,
                 device="cuda"):
        if mesh_fast:
            raise NotImplementedError(
                "mesh_fast=True is not ported yet: it needs the coarse-to-fine "
                "lattice decode (ROADMAP.md, 'Next, in order': _eval_and_negate_fast)")
        if run_async:
            raise NotImplementedError(
                "run_async (meshing in a worker thread) is not ported yet "
                "(ROADMAP.md, 'Next, in order': run_async)")
        if latent_optimize:
            raise NotImplementedError(
                "latent optimization is not ported yet (ROADMAP.md, 'Next, in "
                "order': latent optimisation with with_merge)")
        self.device = resolve_device(device)
        self.map_cfg = map_cfg
        self._map_mod = HM.map_module(map_cfg)
        self.is_hash = self._map_mod is HM
        self.decoder = decoder.to(self.device)
        self.encoder = encoder.to(self.device)
        self.state = self._map_mod.create_state(map_cfg, self.device)
        tcfg = tcfg._replace(depth_cut_min=float(depth_cut[0]),
                             depth_cut_max=float(depth_cut[1]))
        self.tracker = SDFTracker(map_cfg, tcfg, self.decoder, calib,
                                  self.device)
        self.integrate_interval = integrate_interval
        mesher_cls = HashMeshExtractor if self.is_hash else MeshExtractor
        self.mesher = mesher_cls(map_cfg, self.decoder,
                                 voxel_resolution=mesh_resolution,
                                 max_triangles=max_triangles) if meshing else None
        self.meshing_interval = (meshing_interval if meshing_interval > 0
                                 else integrate_interval)
        self.mesh_max_std = mesh_max_std
        self.first_iso: Optional[Isometry] = None
        # mapping-only: every frame takes its ground-truth pose, no tracking
        self.use_gt_poses = False
        # profile=True waits for the device after each stage to time it
        self.profile = profile
        self.timings: Dict[str, List[float]] = {"track": [], "integrate": [], "mesh": []}
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    @classmethod
    def from_config(cls, args, calib: Intrinsic, first_iso: Isometry,
                    capacity: int = 1 << 16, point_budget: int = 1 << 14,
                    meshing: bool = True, device="cuda") -> "SLAMSystem":
        """Build from a reference-style fusion config namespace
        (configs/fusion-synthetic.yaml, configs/fusion-lr-kt.yaml,
        configs/fusion-scannet.yaml).  The hash-indexed map when the mapping
        config has no bounds or asks for ``indexer: hash``, with a table of
        4 x ``capacity`` entries as the JAX package builds it."""
        mapping = dict_to_args(args.mapping) if isinstance(args.mapping, dict) else args.mapping
        tracking = dict_to_args(args.tracking) if isinstance(args.tracking, dict) else args.tracking
        dec, enc, spec = load_prior(args.training_hypers, args.using_epoch, device=device)
        if getattr(mapping, "indexer", None) == "hash" or not hasattr(mapping, "bound_min"):
            map_cfg = HM.HashMapConfig.from_args(mapping, latent_dim=spec.latent_size,
                                                 capacity=capacity,
                                                 table_size=4 * capacity)
        else:
            map_cfg = M.MapConfig.from_args(mapping, latent_dim=spec.latent_size,
                                            capacity=capacity)
        tcfg = TrackerConfig.from_args(tracking, point_budget=point_budget)
        system = cls(map_cfg, tcfg, dec, enc, calib,
                     integrate_interval=int(getattr(args, "integrate_interval", 20)),
                     depth_cut=(float(getattr(args, "depth_cut_min", 0.5)),
                                float(getattr(args, "depth_cut_max", 5.0))),
                     mesh_resolution=int(getattr(args, "resolution", 4)),
                     mesh_fast=bool(getattr(args, "mesh_fast", False)),
                     meshing_interval=int(getattr(args, "meshing_interval", -1)),
                     run_async=bool(getattr(args, "run_async", False)),
                     meshing=meshing,
                     latent_optimize=bool(getattr(mapping, "latent_optimize", False)),
                     device=device)
        system.first_iso = first_iso
        return system

    # -- per-frame step ------------------------------------------------------

    def _stage_done(self, stage: str, t0: float) -> None:
        if self.profile:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings[stage].append(time.perf_counter() - t0)

    def _mesh(self) -> None:
        t0 = time.perf_counter()
        self.state = self.mesher.extract(self.state, max_std=self.mesh_max_std)
        self._stage_done("mesh", t0)

    def process_frame(self, frame: FrameData,
                      packed: Optional[torch.Tensor] = None,
                      driver: Optional[str] = None) -> Pose:
        """Track (and on schedule fuse and mesh) one frame.
        Returns the device pose.  ``packed``: optionally the frame's
        :func:`~.core.tracker.pack_frame` buffer already on the device.
        ``driver``: :meth:`~.core.tracker.SDFTracker.track_camera_packed`'s
        (by default the program on the card, the host loop on the CPU)."""
        t0 = time.perf_counter()
        set_pose = None
        if self.use_gt_poses:
            if frame.gt_pose is None:
                raise ValueError("use_gt_poses needs a sequence with ground truth")
            set_pose = frame.gt_pose
        elif self.tracker.n_tracked == 0:
            set_pose = self.first_iso if self.first_iso is not None else (
                frame.gt_pose if frame.gt_pose is not None else Isometry())
        tr = self.tracker
        if packed is None:
            packed = torch.from_numpy(tracker_mod.pack_frame(
                frame.rgb, frame.depth, tr.calib.dcam_scale,
                lossless=tr.tcfg.lossless_packing)).to(self.device)
        pose = tr.track_camera_packed(self.state, packed, frame.depth.shape[1],
                                      set_pose, driver=driver)
        self._stage_done("track", t0)
        if (tr.n_tracked - 1) % self.integrate_interval == 0:
            t0 = time.perf_counter()
            w_pts, w_nrm, w_mask = tr.last_pc_world(pose)
            self.state = self._map_mod.integrate_keyframe(
                self.map_cfg, self.encoder, self.state, w_pts, w_nrm, w_mask)
            self._stage_done("integrate", t0)
        if self.mesher is not None and (tr.n_tracked - 1) % self.meshing_interval == 0:
            self._mesh()
        return pose

    # -- chunked step ----------------------------------------------------------

    def process_chunk(self, packed_chunk: torch.Tensor, w: int) -> Pose:
        """Track + fuse K frames through :func:`track_fuse_scan`.

        Same per-frame semantics as K :meth:`process_frame` calls with the
        ``integrate_interval`` schedule; mesh extraction (if enabled) runs
        once after the chunk when a frame of it hits ``meshing_interval``.
        Frame 0 must have been processed via :meth:`process_frame` first (it
        seeds the pose)."""
        tr = self.tracker
        if tr.n_tracked == 0:
            raise RuntimeError("process frame 0 first (it sets the pose)")
        if self.use_gt_poses:
            raise RuntimeError("mapping-only mode (use_gt_poses) runs the per-frame path")
        K = int(packed_chunk.shape[0])
        start = tr.n_tracked
        do_integrate = [(start + k) % self.integrate_interval == 0 for k in range(K)]
        carry, (Rs, ts, _) = track_fuse_scan(tr, self.encoder, self.state,
                                             packed_chunk, do_integrate, w)
        self.state = carry.state
        tr.last_pyramid = carry.pyramid
        tr.rgb_weight, tr.n_unstable = carry.rgb_weight, carry.n_unstable
        tr.last_delta = carry.delta
        # a later per-frame integrate fuses tracker.last_pc_world, which must
        # see this chunk's final frame
        tr.last_processed = carry.processed
        tr.last_world = None
        tr.append_pose_chunk(Rs, ts)
        if self.mesher is not None and any(
                (start + k) % self.meshing_interval == 0 for k in range(K)):
            self._mesh()
        return tr.last_pose

    # -- offline runner --------------------------------------------------------

    def _upload(self, array: np.ndarray):
        """Host array -> (device tensor, the event its copy ends with).  On
        the card the copy leaves pinned memory on a stream of its own."""
        t = torch.from_numpy(array)
        if self._copy_stream is None:
            return t, None
        with torch.cuda.stream(self._copy_stream):
            out = t.pin_memory().to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return out, done

    def run_sequence(self, sequence: RGBDSequence, max_frames: int = -1,
                     prefetch: int = 3, chunk: int = 0) -> Dict[str, Any]:
        """Run the sequence with a background load + upload pipeline: a side
        thread renders or decodes frames, packs them and uploads them while
        the device works on earlier ones.

        ``chunk > 1`` stacks that many frames into one upload and one
        :meth:`process_chunk` (the first frame goes alone, the tail may be
        shorter); poses are identical to the per-frame path's."""
        n = len(sequence) if max_frames < 0 else min(max_frames, len(sequence))
        self.first_iso = self.first_iso or sequence.first_iso
        start = self.tracker.n_tracked      # this call's slice of the history
        use_chunk = chunk if (chunk > 1 and not self.use_gt_poses) else 0
        tcfg, dcam = self.tracker.tcfg, self.tracker.calib.dcam_scale
        q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))

        def feeder():
            try:
                batch: list = []
                for i, frame in enumerate(sequence):
                    if i >= n:
                        break
                    w = frame.depth.shape[1]
                    pk = tracker_mod.pack_frame(frame.rgb, frame.depth, dcam,
                                                lossless=tcfg.lossless_packing)
                    if not use_chunk or (i == 0 and start == 0):
                        q.put(("frame", frame, self._upload(pk), w))
                        continue
                    batch.append(pk)
                    if len(batch) == use_chunk:
                        q.put(("chunk", None, self._upload(np.stack(batch)), w))
                        batch = []
                if batch:
                    q.put(("chunk", None, self._upload(np.stack(batch)), w))
            except Exception as e:          # surface loader errors downstream
                q.put(e)
            q.put(None)

        thread = threading.Thread(target=feeder, daemon=True)
        thread.start()
        i = 0
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            kind, frame, (packed, uploaded), w = item
            if uploaded is not None:
                torch.cuda.current_stream().wait_event(uploaded)
                packed.record_stream(torch.cuda.current_stream())
            if kind == "chunk":
                self.process_chunk(packed, w)
                i += int(packed.shape[0])
            else:
                self.process_frame(frame, packed=packed)
                i += 1
            if i % 25 < (use_chunk or 1):
                logging.info("frame %d/%d", i, n)
        thread.join()
        trajectory = self.tracker.all_pd_pose[start:]
        result: Dict[str, Any] = {
            "n_frames": len(trajectory),
            "trajectory": trajectory,
            "n_voxels": int(self.state.n_occupied),
            # allocations dropped at the map's capacity: nonzero means the
            # run lost coverage.  The latent optimizer's counter is the JAX
            # result's key; the port does not run it.
            "alloc_overflow": int(self.state.overflow),
            "opt_overflow": 0,
        }
        gt = sequence.gt_trajectory
        if gt is not None and all(g is not None for g in gt[:len(trajectory)]):
            result["ate_rmse"] = ate_rmse(gt[:len(trajectory)], trajectory)
        for k, v in self.timings.items():
            if v:
                # median: a stage's first call also pays for its set-up
                result[f"{k}_ms"] = 1e3 * float(np.median(v))
                result[f"{k}_first_ms"] = 1e3 * float(v[0])
        return result

    def save_trajectory(self, path) -> None:
        """TUM format: id tx ty tz qx qy qz qw."""
        with open(path, "w") as f:
            for i, p in enumerate(self.tracker.all_pd_pose):
                qw, qx, qy, qz = p.q.q
                f.write(f"{i} {p.t[0]} {p.t[1]} {p.t[2]} {qx} {qy} {qz} {qw}\n")

    def save_map(self, path) -> None:
        """Write the map in the JAX package's npz format."""
        self._map_mod.save_map(path, self.map_cfg, self.state)


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description="difusion-tpu SLAM, PyTorch/CUDA port")
    parser.add_argument("config", help="fusion yaml (reference format)")
    parser.add_argument("--max-frames", type=int, default=-1)
    parser.add_argument("--output", type=str, default="slam_out")
    parser.add_argument("--no-mesh", action="store_true")
    parser.add_argument("--profile", action="store_true",
                        help="per-stage device-synced timings")
    parser.add_argument("--xprof", type=str, default="",
                        help="not ported: a profiler trace into this dir")
    parser.add_argument("--chunk", type=int, default=0,
                        help="stack N frames per upload and track each as one "
                             "graph launch (same poses as per-frame)")
    parser.add_argument("--interactive", action="store_true",
                        help="not ported: terminal step-through")
    parser.add_argument("--gt-poses", action="store_true",
                        help="mapping-only: fuse under the ground-truth "
                             "trajectory, no tracking")
    parser.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="KEY=VALUE",
                        help="override a (possibly nested, dot-separated) "
                             "config key, e.g. --set sequence_kwargs.path=X "
                             "--set tracking.rgb.weight=300")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    cli = parser.parse_args(argv)
    if cli.interactive:
        raise NotImplementedError(
            "--interactive is not ported yet (ROADMAP.md, 'Next, in order': "
            "--interactive / --xprof / core/visuals.py)")
    if cli.xprof:
        raise NotImplementedError(
            "--xprof is not ported yet (ROADMAP.md, 'Next, in order': "
            "--interactive / --xprof / core/visuals.py)")

    logging.basicConfig(level=logging.INFO)
    args = load_yaml_args(cli.config)
    for assignment in cli.overrides:
        apply_override(args, assignment)
    seq = open_sequence(args.sequence_type, **args.sequence_kwargs)
    system = SLAMSystem.from_config(args, getattr(seq, "calib", None), seq.first_iso,
                                    meshing=not cli.no_mesh, device=cli.device)
    system.profile = cli.profile
    system.use_gt_poses = cli.gt_poses
    result = system.run_sequence(seq, cli.max_frames, chunk=cli.chunk)

    out = Path(cli.output)
    out.mkdir(parents=True, exist_ok=True)
    system.save_trajectory(out / "trajectory.txt")
    system.save_map(out / "map.npz")
    if system.mesher is not None:
        system.mesher.write_ply(str(out / "mesh.ply"))
    summary = {k: v for k, v in result.items() if k != "trajectory"}
    print(json.dumps(summary, indent=2, default=float))
    return result


if __name__ == "__main__":
    main()
