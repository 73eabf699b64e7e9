"""Online SLAM: track + fuse + optimize + mesh, and the offline runner
``python -m difusion_tpu_torch.slam <fusion yaml>`` (counterpart of
difusion_tpu/slam.py): ``--interactive`` steps through the sequence from the
terminal (:meth:`SLAMSystem.run_interactive`), ``--profile`` adds each
stage's median and first time to the summary, ``--xprof DIR`` writes a
``torch.profiler`` Chrome trace of the run into ``DIR``.  Both come from the
port's spans (:mod:`.utils.tracing`), which either switches on: the stage
timings are the ``slam.track``, ``slam.fuse`` and ``slam.mesh`` spans, and
the trace holds every span as an annotation beside the device's work.

The map is the dense one (``core/map.py``) when the mapping config gives
bounds, else (or with ``indexer: hash``) the hash-indexed one
(``core/hash_map.py``).  Per frame: ``SDFTracker.track_camera_packed`` (the
first frame takes its given pose); every ``integrate_interval`` frames
``integrate_keyframe`` with the tracked pose applied to the frame's point
cloud; and every ``meshing_interval`` frames (by default the integrate
interval) an incremental mesh extract, synchronous or (``run_async``) in a
worker thread on a stream of its own over a snapshot of the state.

With ``latent_optimize`` each fusion is followed by Adam over the latents of
the converged voxels around the fused keyframe (``core/map.optimize_latents``):
under ``latent_optimize_mode="sync"`` the result replaces the state at once;
under ``"interleaved"`` it waits and merges (delta de-integration) at the
start of the next fusion, on both paths at the same point of the schedule.

Two paths run that program.  :meth:`SLAMSystem.process_frame` tracks one
frame at a time, :func:`track_fuse_scan` / :meth:`SLAMSystem.process_chunk`
K frames from one stacked upload, with fusion between frames on those the
schedule names.  Both track each frame as the tracker's
:class:`~.core.tracker.TrackProgram`: on the card one launch of a CUDA graph
whose GN loops end on the device, so the host reads no exit flag; on the
CPU the same segments one by one.  Both compute the same values.

Both paths take the tracker's (h, 3w) packed frame.  Where the camera's
uint8 RGB and uint16 depth arrive (:func:`.ops.frame_pack.takes`), the
frames' raw arrays are copied into one pinned buffer, uploaded and packed on
the card by one launch of ``csrc/frame_pack.cu`` (:mod:`.ops.frame_pack`);
float frames and ``lossless_packing`` pack in numpy on the host
(:func:`~.core.tracker.pack_frame`) and upload the packed bytes.

Spans (with the recorder on; each carries its frame's index):
``slam.run_sequence`` and, inside it, ``slam.wait_feed`` (the main thread
waiting for the feeder); on the feeder thread ``slam.feed.pack`` (a
frame's copy into the pinned buffer, or its numpy pack), ``slam.feed.stack``
(numpy packs only) and ``slam.feed.upload`` (the copy, and the pack's launch
or the pin); ``slam.process_chunk`` and ``slam.process_frame``, the latter
holding ``slam.frame.pack`` and ``slam.frame.upload`` (the same, the numpy
route's copy pageable: the host waits for the card there); and on both paths
``slam.track``, ``slam.fuse`` and ``slam.mesh``.
"""
from __future__ import annotations

import json
import logging
import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
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
from .ops import frame_pack
from .ops.imgproc import Intrinsic, Pyramid
from .ops.se3 import Pose
from .utils import tracing
from .utils.motion import Isometry, ate_rmse

__all__ = ["SLAMSystem", "load_prior", "track_fuse_scan"]

_PointCloud = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# SLAMSystem.timings' stages and the spans they read
STAGE_SPANS = {"track": "slam.track", "integrate": "slam.fuse", "mesh": "slam.mesh"}


def _end_stage(s: int, device: torch.device, sync: bool) -> None:
    """End stage span ``s`` (if open), first waiting for the card under
    ``sync`` (``SLAMSystem.profile``), so that it times the stage's work."""
    if s >= 0:
        if sync and device.type == "cuda":
            torch.cuda.synchronize(device)
        tracing.end(s)


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
    world: _PointCloud               # its world-space cloud
    integrated: _PointCloud          # the last fused frame's world-space cloud


def apply_merge(state, merge_args):
    """Fold a pending optimizer result into ``state``: ``merge_args`` =
    (old latents, new latents, old counts, touched, the result's
    opt_overflow), the counter kept as the larger of the two (each only
    grows)."""
    old_lat, new_lat, old_cnt, touched, snap_overflow = merge_args
    state = M.merge_optimize_result(state, old_lat, new_lat, old_cnt, touched)
    return state._replace(opt_overflow=torch.maximum(state.opt_overflow, snap_overflow))


def track_fuse_scan(tracker: SDFTracker, encoder: Encoder, state: M.MapState,
                    packed_chunk: torch.Tensor, do_integrate: Sequence[bool],
                    w: int, merge_at: Optional[Sequence[bool]] = None,
                    merge_args=None, with_merge: bool = False, sync: bool = False):
    """K sequential frame steps (unpack + preprocess + GN track + optional
    encoder fusion) from one stacked buffer, starting from ``tracker``'s
    temporal state (which it does not change: see
    :meth:`SLAMSystem.process_chunk`).

    ``packed_chunk``: (K, h, 3w) stacked :func:`~.core.tracker.pack_frame`
    buffers on the device ((K, h, 16w) for the lossless packing).
    ``do_integrate``: K host bools -- fuse that frame's point cloud after
    tracking it.  The schedule is known on the host, so fusion needs no
    device-side branch.  ``with_merge``: fold a pending optimizer result
    (``merge_args``, see :func:`apply_merge`) into the map just before the
    fusion of each frame that ``merge_at`` (K host bools) flags, where the
    per-frame path merges it; the tracker's program then loads the merged
    and fused tables for the next frame.  ``sync``: wait for the card at
    the end of each ``slam.track`` and ``slam.fuse`` span.  Returns
    ``(ScanCarry, (Rs (K, 3, 3), ts (K, 3), energies (K,)))``.  Numerically
    identical to K ``process_frame`` calls."""
    if with_merge and (merge_at is None or merge_args is None):
        raise ValueError("with_merge needs merge_at and merge_args")
    K = int(packed_chunk.shape[0])
    dev = packed_chunk.device
    integrate = HM.map_module(tracker.map_cfg).integrate_keyframe
    prog = tracker.program(packed_chunk.shape[1:], w)
    prog.load_state(state)
    outs = torch.empty(K, 13, device=dev)
    budget = tracker.tcfg.point_budget
    integrated = (torch.zeros(budget, 3, device=dev), torch.zeros(budget, 3, device=dev),
                  torch.zeros(budget, dtype=torch.bool, device=dev))
    first = tracker.n_tracked
    for k in range(K):
        s = tracing.begin("slam.track", first + k) if tracing.ON else -1
        prog.preprocess_and_track(packed_chunk[k])
        outs[k].copy_(prog.out)
        _end_stage(s, dev, sync)
        if do_integrate[k]:
            s = tracing.begin("slam.fuse", first + k) if tracing.ON else -1
            if with_merge and merge_at[k]:
                state = apply_merge(state, merge_args)
            state = integrate(tracker.map_cfg, encoder, state, *prog.world)
            prog.load_state(state)
            integrated = tuple(t.clone() for t in prog.world)
            _end_stage(s, dev, sync)
    carry = ScanCarry(state, prog.last, prog.prev, prog.rgb_weight, prog.n_unstable,
                      prog.delta, prog.cur._replace(pyramid=prog.prev), prog.world,
                      integrated)
    return carry, (outs[:, :9].reshape(K, 3, 3), outs[:, 9:12], outs[:, 12])


class _FeedUpload:
    """The frames of one upload of :meth:`SLAMSystem.run_sequence`'s
    feeder: a frame alone or a chunk.  Where :func:`.ops.frame_pack.takes`
    the frames (``raw``), their arrays are copied into one pinned buffer to
    be uploaded and packed on the card; else each is packed by numpy."""

    def __init__(self, frame: FrameData, item: int, alone: bool, size: int, raw: bool,
                 pin: bool):
        self.frame, self.item, self.alone, self.size, self.raw = frame, item, alone, size, raw
        self.n = 0
        self.packs: List[np.ndarray] = []
        self.staged = frame_pack.RawFrames(size, *frame.depth.shape, pin=pin) if raw else None

    def put(self, frame: FrameData, item: int, dcam_scale: float, lossless: bool) -> None:
        s = tracing.begin("slam.feed.pack", item) if tracing.ON else -1
        if self.raw:
            self.staged.put(self.n, frame.rgb, frame.depth)
        else:
            self.packs.append(tracker_mod.pack_frame(frame.rgb, frame.depth, dcam_scale,
                                                     lossless=lossless))
        self.n += 1
        if s >= 0:
            tracing.end(s)


class SLAMSystem:
    """Track + fuse (+ optimize) + mesh over an RGB-D stream on ``device``
    (``"cuda"`` unless the caller asks for ``"cpu"``).

    ``mesh_fast``: the mesher's coarse-to-fine lattice decode.
    ``run_async``: extracts run in a worker thread (on the card, on a stream
    of its own) over a snapshot of the state; :meth:`finish_meshing` joins
    the one in flight and raises its error.  ``latent_optimize``,
    ``latent_optimize_mode`` (``"interleaved"`` or ``"sync"``),
    ``optim_n_iters`` and ``code_reg_lambda``: see the module's docstring;
    the samples' noise comes from the system's own generator on the device,
    seeded with 7."""

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
                 latent_optimize_mode: str = "interleaved",
                 optim_n_iters: int = 20,
                 code_reg_lambda: float = 0.0,
                 device="cuda"):
        if latent_optimize_mode not in ("interleaved", "sync"):
            raise ValueError(f"latent_optimize_mode {latent_optimize_mode!r} "
                             "(use 'interleaved' or 'sync')")
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
                                 max_triangles=max_triangles,
                                 fast=mesh_fast) if meshing else None
        self.meshing_interval = (meshing_interval if meshing_interval > 0
                                 else integrate_interval)
        self.mesh_max_std = mesh_max_std
        self.first_iso: Optional[Isometry] = None
        # mapping-only: every frame takes its ground-truth pose, no tracking
        self.use_gt_poses = False
        self._profile_from = -1
        self.profile = profile
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # run_async: one extract at a time in a worker thread
        self._mesh_executor = (ThreadPoolExecutor(max_workers=1)
                               if run_async and meshing else None)
        self._mesh_stream = (torch.cuda.Stream(self.device)
                             if self._mesh_executor and self.device.type == "cuda"
                             else None)
        self._mesh_future: Optional[Future] = None
        self.latent_optimize = latent_optimize
        self.latent_optimize_mode = latent_optimize_mode
        self.optim_n_iters = optim_n_iters
        self.code_reg_lambda = code_reg_lambda
        # interleaved: (old latents, old counts, old optimized flags, the
        # optimized state), merged at the next fusion
        self._pending_opt: Optional[tuple] = None
        self._opt_gen = torch.Generator(device=self.device)
        self._opt_gen.manual_seed(7)

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
                     # the optimizer's keys live under mapping, as in the
                     # reference's configs
                     latent_optimize=bool(getattr(mapping, "latent_optimize", False)),
                     optim_n_iters=int(getattr(mapping, "optim_n_iters", 20)),
                     code_reg_lambda=(float(getattr(mapping, "code_reg_lambda", 0.0))
                                      if getattr(mapping, "code_regularization", False)
                                      else 0.0),
                     device=device)
        system.first_iso = first_iso
        return system

    # -- stage timings ---------------------------------------------------------

    @property
    def profile(self) -> bool:
        """True: the stage spans wait for the card before they end, so that
        they time each stage's work.  Setting it switches the process's span
        recorder on (it stays on), and :attr:`timings` reads the spans
        recorded from then on."""
        return self._profile_from >= 0

    @profile.setter
    def profile(self, on: bool) -> None:
        if on and not self.profile:
            tracing.enable()
            self._profile_from = tracing.n_spans()
        elif not on:
            self._profile_from = -1

    @property
    def timings(self) -> Dict[str, List[float]]:
        """Seconds of each stage (``track``, ``integrate``, ``mesh``): the
        durations of its spans (:data:`STAGE_SPANS`) since :attr:`profile`
        was switched on; empty lists without it."""
        spans = tracing.spans(self._profile_from) if self.profile else []
        return {stage: [s.seconds for s in spans if s.name == name and s.end_ns >= 0]
                for stage, name in STAGE_SPANS.items()}

    def _stage_end(self, s: int) -> None:
        _end_stage(s, self.device, self.profile)

    # -- per-frame step ------------------------------------------------------

    def _mesh(self) -> None:
        """An incremental extract: here, or (``run_async``) submitted to the
        worker over a snapshot of the state, whose dirty flags clear now so
        that fusion marks new work for the next extract."""
        s = tracing.begin("slam.mesh") if tracing.ON else -1
        if self._mesh_executor is None:
            self.state = self.mesher.extract(self.state, max_std=self.mesh_max_std)
        else:
            snapshot = self.state
            self.state = snapshot._replace(mesh_dirty=torch.zeros_like(snapshot.mesh_dirty))
            self.finish_meshing()                    # one extract in flight
            ready = None
            if self._mesh_stream is not None:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
            self._mesh_future = self._mesh_executor.submit(self._extract_snapshot,
                                                           snapshot, ready)
        self._stage_end(s)

    def _extract_snapshot(self, snapshot, ready: Optional[torch.cuda.Event]) -> None:
        """The worker's extract.  On the card it runs on the mesh stream once
        the main stream has made the snapshot (``ready``), and waits for the
        stream before it drops the snapshot, whose memory the main stream's
        pool may then hand out again."""
        if ready is None:
            self.mesher.extract(snapshot, max_std=self.mesh_max_std)
            return
        with torch.cuda.stream(self._mesh_stream):
            self._mesh_stream.wait_event(ready)
            self.mesher.extract(snapshot, max_std=self.mesh_max_std)
        self._mesh_stream.synchronize()

    def finish_meshing(self) -> None:
        """Join the extract in flight, if any; its error raises here."""
        if self._mesh_future is not None:
            future, self._mesh_future = self._mesh_future, None
            future.result()

    def _fuse(self, w_pts, w_nrm, w_mask) -> None:
        """Fuse a keyframe: merge a pending optimizer result first, then the
        encoder fusion, then (``latent_optimize``) optimize around it."""
        if self._pending_opt is not None:
            self.state = apply_merge(self.state, self._take_pending())
        self.state = self._map_mod.integrate_keyframe(
            self.map_cfg, self.encoder, self.state, w_pts, w_nrm, w_mask)
        if self.latent_optimize:
            self._optimize(w_pts, w_nrm, w_mask)
        if self.tracker.cond is not None:
            # the fused slots' conditioning (a conditioned family), here inside
            # slam.fuse
            self.tracker.cond.refresh(self.state.latents)

    def _take_pending(self) -> tuple:
        """The pending result as :func:`apply_merge`'s arguments."""
        old_lat, old_cnt, pre_optimized, opt_state = self._pending_opt
        self._pending_opt = None
        return (old_lat, opt_state.latents, old_cnt, opt_state.optimized & ~pre_optimized,
                opt_state.opt_overflow)

    def _draw_noise(self, n: int) -> torch.Tensor:
        """The optimizer samples' (n, 8) standard-normal draw, on the device."""
        return torch.randn((n, 8), generator=self._opt_gen, device=self.device)

    def _optimize(self, w_pts, w_nrm, w_mask) -> None:
        """Adam over the converged voxels around a fused keyframe's world
        cloud; the result replaces the state (sync) or waits for the next
        fusion (interleaved).  The snapshot holds the state's own tensors:
        nothing writes a state's tensors in place."""
        noise = self._draw_noise(w_pts.shape[0])
        samples = self._map_mod.build_optimize_samples(self.map_cfg, self.state, w_pts,
                                                       w_nrm, w_mask, noise)
        opt_state = self._map_mod.optimize_latents(
            self.map_cfg, self.decoder, self.state, *samples, n_iters=self.optim_n_iters,
            code_reg_lambda=self.code_reg_lambda)
        if self.latent_optimize_mode == "sync":
            self.state = opt_state
        else:
            self._pending_opt = (self.state.latents, self.state.obs_count,
                                 self.state.optimized, opt_state)

    def process_frame(self, frame: FrameData,
                      packed: Optional[torch.Tensor] = None,
                      driver: Optional[str] = None) -> Pose:
        """Track (and on schedule fuse and mesh) one frame.
        Returns the device pose.  ``packed``: optionally the frame's
        :func:`~.core.tracker.pack_frame` buffer already on the device.
        ``driver``: :meth:`~.core.tracker.SDFTracker.track_camera_packed`'s
        (by default the program captured on the card; ``"host"`` runs it
        uncaptured)."""
        set_pose = None
        if self.use_gt_poses:
            if frame.gt_pose is None:
                raise ValueError("use_gt_poses needs a sequence with ground truth")
            set_pose = frame.gt_pose
        elif self.tracker.n_tracked == 0:
            set_pose = self.first_iso if self.first_iso is not None else (
                frame.gt_pose if frame.gt_pose is not None else Isometry())
        tr = self.tracker
        sf = tracing.begin("slam.process_frame", tr.n_tracked) if tracing.ON else -1
        if packed is None:
            packed = self._pack_frame(frame)
        s = tracing.begin("slam.track") if tracing.ON else -1
        pose = tr.track_camera_packed(self.state, packed, frame.depth.shape[1],
                                      set_pose, driver=driver)
        self._stage_end(s)
        if (tr.n_tracked - 1) % self.integrate_interval == 0:
            s = tracing.begin("slam.fuse") if tracing.ON else -1
            self._fuse(*tr.last_pc_world(pose))
            self._stage_end(s)
        if self.mesher is not None and (tr.n_tracked - 1) % self.meshing_interval == 0:
            self._mesh()
        if sf >= 0:
            tracing.end(sf)
        return pose

    def _pack_frame(self, frame: FrameData) -> torch.Tensor:
        """The frame's (h, 3w) packed buffer on the device: packed there on
        the current stream after a non-blocking upload of its staged arrays
        where :func:`.ops.frame_pack.takes` them, else packed by numpy and
        uploaded from pageable memory."""
        tcfg = self.tracker.tcfg
        raw = frame_pack.takes(frame.rgb, frame.depth, tcfg.lossless_packing)
        s = tracing.begin("slam.frame.pack") if tracing.ON else -1
        if raw:
            staged = frame_pack.RawFrames(1, *frame.depth.shape,
                                          pin=self.device.type == "cuda")
            staged.put(0, frame.rgb, frame.depth)
        else:
            buf = tracker_mod.pack_frame(frame.rgb, frame.depth, self.tracker.calib.dcam_scale,
                                         lossless=tcfg.lossless_packing)
        if s >= 0:
            tracing.end(s)
        s = tracing.begin("slam.frame.upload", wait=not raw) if tracing.ON else -1
        packed = staged.pack(self.device)[0] if raw else torch.from_numpy(buf).to(self.device)
        if s >= 0:
            tracing.end(s)
        return packed

    # -- chunked step ----------------------------------------------------------

    def process_chunk(self, packed_chunk: torch.Tensor, w: int) -> Pose:
        """Track + fuse K frames through :func:`track_fuse_scan`.

        Same per-frame semantics as K :meth:`process_frame` calls with the
        ``integrate_interval`` schedule; mesh extraction (if enabled) runs
        once after the chunk, synchronously (after joining any extract in
        flight), when a frame of it hits ``meshing_interval``.  A pending
        optimizer result merges at the chunk's first fusion, and the
        optimizer runs after the chunk on its last fused keyframe: with one
        fusion a chunk the same steps as the per-frame path.  Frame 0 must
        have been processed via :meth:`process_frame` first (it seeds the
        pose)."""
        tr = self.tracker
        if tr.n_tracked == 0:
            raise RuntimeError("process frame 0 first (it sets the pose)")
        if self.use_gt_poses:
            raise RuntimeError("mapping-only mode (use_gt_poses) runs the per-frame path")
        K = int(packed_chunk.shape[0])
        start = tr.n_tracked
        sc = tracing.begin("slam.process_chunk", start) if tracing.ON else -1
        do_integrate = [(start + k) % self.integrate_interval == 0 for k in range(K)]
        merge_at, merge_args = None, None
        if self._pending_opt is not None and any(do_integrate):
            first = do_integrate.index(True)
            merge_at = [k == first for k in range(K)]
            merge_args = self._take_pending()
        carry, (Rs, ts, _) = track_fuse_scan(tr, self.encoder, self.state,
                                             packed_chunk, do_integrate, w,
                                             merge_at=merge_at, merge_args=merge_args,
                                             with_merge=merge_args is not None,
                                             sync=self.profile)
        self.state = carry.state
        if self.latent_optimize and any(do_integrate):
            self._optimize(*carry.integrated)
        tr.last_pyramid = carry.pyramid
        tr.rgb_weight, tr.n_unstable = carry.rgb_weight, carry.n_unstable
        tr.last_delta = carry.delta
        tr.last_processed, tr.last_world = carry.processed, carry.world
        tr.append_pose_chunk(Rs, ts)
        if self.mesher is not None and any(
                (start + k) % self.meshing_interval == 0 for k in range(K)):
            self.finish_meshing()
            s = tracing.begin("slam.mesh", start) if tracing.ON else -1
            self.state = self.mesher.extract(self.state, max_std=self.mesh_max_std)
            self._stage_end(s)
        if sc >= 0:
            tracing.end(sc)
        return tr.last_pose

    # -- offline runner --------------------------------------------------------

    def _upload(self, fill, item: int):
        """``fill()`` -> (its device tensor, the event its work ends with).
        On the card ``fill`` runs on a stream of its own: a copy from pinned
        memory and, where the frames' raw arrays go up, their pack.
        ``item``: the index of its (first) frame."""
        s = tracing.begin("slam.feed.upload", item) if tracing.ON else -1
        done = None
        if self._copy_stream is None:
            out = fill()
        else:
            with torch.cuda.stream(self._copy_stream):
                out = fill()
                done = torch.cuda.Event()
                done.record()
        if s >= 0:
            tracing.end(s)
        return out, done

    def run_sequence(self, sequence: RGBDSequence, max_frames: int = -1,
                     prefetch: int = 3, chunk: int = 0) -> Dict[str, Any]:
        """Run the sequence with a background load + upload pipeline: a side
        thread renders or decodes frames, stages or packs them and uploads
        them while the device works on earlier ones.

        ``chunk > 1`` stacks that many frames into one upload and one
        :meth:`process_chunk` (the first frame goes alone, the tail may be
        shorter); poses are identical to the per-frame path's.  The call's
        first frame chooses how every frame goes up: packed on the card where
        :func:`.ops.frame_pack.takes` it (a later frame it does not take
        raises), else packed by numpy.  With
        :attr:`profile` the result holds each stage's median and first time
        (``track_ms``, ``track_first_ms``, ``integrate_ms``, ...)."""
        n = len(sequence) if max_frames < 0 else min(max_frames, len(sequence))
        self.first_iso = self.first_iso or sequence.first_iso
        start = self.tracker.n_tracked      # this call's slice of the history
        use_chunk = chunk if (chunk > 1 and not self.use_gt_poses) else 0
        tcfg, dcam = self.tracker.tcfg, self.tracker.calib.dcam_scale
        pin = self._copy_stream is not None
        q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        sr = tracing.begin("slam.run_sequence", start) if tracing.ON else -1

        def send(up: _FeedUpload) -> None:
            """Upload ``up`` and queue (kind, frame, (packed, event), w)."""
            if up.raw:
                packed, done = self._upload(lambda: up.staged.pack(self.device, up.n), up.item)
                if up.alone:
                    packed = packed[0]
            else:
                array = up.packs[0]
                if not up.alone:
                    s = tracing.begin("slam.feed.stack", up.item) if tracing.ON else -1
                    array = np.stack(up.packs)
                    if s >= 0:
                        tracing.end(s)
                t = torch.from_numpy(array)
                packed, done = self._upload(
                    lambda: t.pin_memory().to(self.device, non_blocking=True) if pin else t,
                    up.item)
            q.put(("frame" if up.alone else "chunk", up.frame, (packed, done),
                   up.frame.depth.shape[1]))

        def feeder():
            try:
                up, raw = None, None        # the upload being filled; the route, from frame 0
                for i, frame in enumerate(sequence):
                    if i >= n:
                        break
                    takes = frame_pack.takes(frame.rgb, frame.depth, tcfg.lossless_packing)
                    if raw is None:
                        raw = takes
                    elif raw and not takes:
                        raise ValueError(
                            f"run_sequence: frame {start + i} is not the camera's uint8 RGB "
                            f"and uint16 depth that the call's first frame was: got "
                            f"{frame.rgb.dtype} RGB, {frame.depth.dtype} depth")
                    if up is None:
                        alone = not use_chunk or (i == 0 and start == 0)
                        up = _FeedUpload(frame, start + i, alone, 1 if alone else use_chunk,
                                         raw, pin)
                    up.put(frame, start + i, dcam, tcfg.lossless_packing)
                    if up.n == up.size:
                        send(up)
                        up = None
                if up is not None:
                    send(up)
            except Exception as e:          # surface loader errors downstream
                q.put(e)
            q.put(None)

        thread = threading.Thread(target=feeder, name="slam-feeder", daemon=True)
        thread.start()
        i = 0
        while True:
            s = tracing.begin("slam.wait_feed", start + i) if tracing.ON else -1
            item = q.get()
            if s >= 0:
                tracing.end(s)
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            kind, frame, (packed, uploaded), w = item
            if uploaded is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(uploaded)
                packed.record_stream(current)
            if kind == "chunk":
                self.process_chunk(packed, w)
                i += int(packed.shape[0])
            else:
                self.process_frame(frame, packed=packed)
                i += 1
            if i % 25 < (use_chunk or 1):
                logging.info("frame %d/%d", i, n)
        thread.join()
        self.finish_meshing()
        if sr >= 0:
            tracing.end(sr)
        trajectory = self.tracker.all_pd_pose[start:]
        result: Dict[str, Any] = {
            "n_frames": len(trajectory),
            "trajectory": trajectory,
            "n_voxels": int(self.state.n_occupied),
            # allocations dropped at the map's capacity, and touched slots
            # beyond the latent optimizer's working table: nonzero means the
            # run lost coverage
            "alloc_overflow": int(self.state.overflow),
            "opt_overflow": int(self.state.opt_overflow),
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

    # -- interactive driver --------------------------------------------------

    def run_interactive(self, sequence: RGBDSequence, max_frames: int = -1,
                        out_dir: Optional[str] = None) -> Dict[str, Any]:
        """Terminal step-through, the reference GUI's key-callback loop
        (',' steps one frame, '.' free-runs) without the Open3D window:

        =========  =========================================================
        Enter / s  step one frame
        r [N]      run to the end (or N more frames)
        m          extract + report the mesh now
        v          render the current mesh + trajectory to view_<i>.png
        i          info: frame counter, pose, voxel count
        q          stop (artifacts are still written by the caller)
        =========  =========================================================

        End of input free-runs to the end.  Frames go through
        :meth:`process_frame`."""
        n = len(sequence) if max_frames < 0 else min(max_frames, len(sequence))
        self.first_iso = self.first_iso or sequence.first_iso
        it = iter(sequence)
        i = 0
        free_run = 0
        print(self.run_interactive.__doc__.split("\n", 1)[1].split("\n\n        End")[0])
        while i < n:
            if free_run <= 0:
                try:
                    cmd = input(f"[frame {i}/{n}] > ").strip().split()
                except EOFError:
                    cmd = ["r"]
                op = cmd[0] if cmd else "s"
                if op == "q":
                    break
                if op == "r":
                    free_run = int(cmd[1]) if len(cmd) > 1 else n - i
                    continue
                if op == "m":
                    if self.mesher is None:
                        print("meshing disabled (--no-mesh)")
                    else:
                        self.finish_meshing()
                        self.state = self.mesher.extract(self.state,
                                                         max_std=self.mesh_max_std)
                        tris, _ = self.mesher.triangles()
                        print(f"mesh: {len(tris)} triangles, "
                              f"{int(self.state.n_occupied)} voxels")
                    continue
                if op == "v":
                    self._interactive_view(out_dir or ".", i)
                    continue
                if op == "i":
                    if self.tracker.last_pose is not None:
                        t = self.tracker.last_pose.t.cpu().numpy()
                        print(f"frame {i}: t={np.round(t, 4)}  "
                              f"voxels={int(self.state.n_occupied)}")
                    else:
                        print("no frames tracked yet")
                    continue
                # fall through: "s" / empty / anything else = step
            else:
                free_run -= 1
            self.process_frame(next(it))
            i += 1
        self.finish_meshing()
        trajectory = self.tracker.all_pd_pose
        result: Dict[str, Any] = {"n_frames": i, "trajectory": trajectory,
                                  "n_voxels": int(self.state.n_occupied),
                                  "alloc_overflow": int(self.state.overflow),
                                  "opt_overflow": int(self.state.opt_overflow)}
        gt = sequence.gt_trajectory
        if gt is not None and all(g is not None for g in gt[:i]):
            result["ate_rmse"] = ate_rmse(gt[:i], trajectory)
        return result

    def _interactive_view(self, out_dir: str, i: int) -> None:
        """Render the mesh (coloured by uncertainty) and the trajectory to
        ``out_dir/view_<i>.png`` through :func:`.core.visuals.view_matplotlib`;
        without matplotlib it says so and returns."""
        if self.mesher is None:
            print("meshing disabled (--no-mesh)")
            return
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            print("matplotlib is not installed: cannot render a view")
            return
        from .core.meshing import jet_rgb
        from .core.visuals import view_matplotlib
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        png = str(Path(out_dir) / f"view_{i:04d}.png")
        verts, faces = self.mesher.vertices_faces()
        stds = self.mesher.triangles()[1].reshape(-1)
        colors = None
        if len(stds):
            colors = jet_rgb(np.clip((stds - stds.min())
                                     / max(stds.max() - stds.min(), 1e-12), 0.0, 1.0))
        traj = (np.array([p.t for p in self.tracker.all_pd_pose])
                if self.tracker.n_tracked else None)
        view_matplotlib(verts, colors, faces, traj, None, save=png)


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description="difusion-tpu SLAM, PyTorch/CUDA port")
    parser.add_argument("config", help="fusion yaml (reference format)")
    parser.add_argument("--max-frames", type=int, default=-1)
    parser.add_argument("--output", type=str, default="slam_out")
    parser.add_argument("--no-mesh", action="store_true")
    parser.add_argument("--profile", action="store_true",
                        help="per-stage timings in the summary (median and "
                             "first, ms): the port's slam.track, slam.fuse and "
                             "slam.mesh spans, each ended after a wait for the "
                             "card")
    parser.add_argument("--xprof", type=str, default="",
                        help="write a torch.profiler Chrome trace (CPU and, on "
                             "the card, CUDA activities) of run_sequence into "
                             "this dir, with the port's spans as annotations")
    parser.add_argument("--chunk", type=int, default=0,
                        help="stack N frames per upload and track each as one "
                             "graph launch (same poses as per-frame)")
    parser.add_argument("--interactive", action="store_true",
                        help="terminal step-through (the reference GUI's "
                             "','/'.'-key loop): Enter steps, r runs, m "
                             "meshes, v renders a view, i prints the pose, q quits")
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

    logging.basicConfig(level=logging.INFO)
    args = load_yaml_args(cli.config)
    for assignment in cli.overrides:
        apply_override(args, assignment)
    seq = open_sequence(args.sequence_type, **args.sequence_kwargs)
    system = SLAMSystem.from_config(args, getattr(seq, "calib", None), seq.first_iso,
                                    meshing=not cli.no_mesh, device=cli.device)
    system.profile = cli.profile
    system.use_gt_poses = cli.gt_poses
    if cli.interactive:
        result = system.run_interactive(seq, cli.max_frames, out_dir=cli.output)
    elif cli.xprof:
        from torch.profiler import ProfilerActivity, profile
        tracing.enable()
        activities = [ProfilerActivity.CPU]
        if system.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            result = system.run_sequence(seq, cli.max_frames, chunk=cli.chunk)
        Path(cli.xprof).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(cli.xprof) / "trace.json"))
    else:
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
