"""The three ways a cell drives the port, chosen by its traffic file's
``entry``:

* ``chunk``: a recorded stream through ``SLAMSystem.run_sequence(chunk=K)``
  (the feeder thread packs and uploads K frames at a time; each frame is one
  launch of the tracker's graph program), meshing off.
* ``frame``: a live stream through ``SLAMSystem.process_frame``, one frame
  at a time; a frame's latency runs from the hand-off of the camera's arrays
  to its pose on the host.  Meshing as the traffic says.
* ``export``: set-up fuses the lap's fusion frames at their ground-truth
  poses (mapping only); the window runs full extracts back to back, as
  ``mesh_tool`` does, with the triangles on the host.

Every driver renders the frames its traffic reads from the seed
(:mod:`.gen.render`), warms up the shapes its traffic uses, and keeps what
its windows produced for the check (:mod:`.check`).  Host spans are taken
here, around the calls into the port, in every run (two clock reads a
call).
"""
from __future__ import annotations

import time
import weakref
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .gen.render import Lap, render_lap

ROOT = Path(__file__).resolve().parent.parent


class Spans:
    """Host spans (name, start, end) on ``time.perf_counter``, kept in
    memory."""

    def __init__(self):
        self.items: List[tuple] = []

    def wrap(self, obj, attr: str, name: Optional[str] = None) -> None:
        """Time every call of ``obj.attr`` (an instance's bound method)."""
        fn = getattr(obj, attr)
        label = name or attr

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.items.append((label, t0, time.perf_counter()))
        setattr(obj, attr, timed)


class LapStream:
    """Stream frames ``first`` .. of a lap as the port's sequence protocol
    (``len``, iteration, ``first_iso``, ``gt_trajectory``): each frame is
    the camera's uint8 RGB and uint16 depth, views of the pinned buffers.
    The stream ends after ``count`` frames, or, with ``deadline``, at the
    first multiple of ``step`` frames once the host clock has passed it."""

    def __init__(self, lap: Lap, calib, first: int, count: int = -1,
                 deadline: float = np.inf, step: int = 1):
        from difusion_tpu_torch.data.production import FrameData
        self._frame_cls = FrameData
        self.lap, self.calib, self.first = lap, calib, first
        self.count, self.deadline, self.step = count, deadline, step
        self.first_iso = None
        self.gt_trajectory = None
        self.k = first

    def __len__(self) -> int:
        return self.count if self.count >= 0 else 1 << 30

    def __iter__(self):
        return self

    def __next__(self):
        n = self.k - self.first
        if n == len(self) or (n % self.step == 0 and time.perf_counter() >= self.deadline):
            raise StopIteration
        rgb, depth = self.lap.frame(self.k)
        self.k += 1
        return self._frame_cls(rgb, depth, None, self.calib, None, self.k - 1)


def gt_pose(lap: Lap, k: int):
    from difusion_tpu_torch.utils.motion import Isometry
    j = lap.index(k)
    return Isometry.from_matrix(lap.R[j], lap.t[j], ortho=True)


def build_system(cfg: dict, device: torch.device, meshing: bool):
    """``SLAMSystem.from_config`` on the configuration's fusion keys."""
    from difusion_tpu_torch.config import dict_to_args
    from difusion_tpu_torch.ops.imgproc import Intrinsic
    from difusion_tpu_torch.slam import SLAMSystem
    fr, assumed = cfg["frames"], cfg["assumed"]
    calib = Intrinsic(*fr["intrinsics"], fr["depth_scale"])
    keys = ("training_hypers", "using_epoch", "resolution", "depth_cut_min",
            "depth_cut_max", "integrate_interval", "mapping", "tracking")
    args = dict_to_args({k: cfg[k] for k in keys})
    args.training_hypers = str(ROOT / cfg["training_hypers"])
    system = SLAMSystem.from_config(args, calib, None, capacity=assumed["capacity"],
                                    point_budget=assumed["point_budget"],
                                    meshing=meshing, device=device)
    system.mesh_max_std = assumed["mesh_max_std"]
    return system, calib


def map_arrays(system) -> dict:
    """The port's map as the check reads it: each allocated slot's cell,
    count and latent, and the allocations the map dropped."""
    st, cfg = system.state, system.map_cfg
    if system.is_hash:
        live = torch.arange(cfg.capacity, device=st.obs_count.device) < st.n_occupied
        cells = st.slot_cell.to(torch.int64)
    else:
        live = st.positions >= 0
        nx, ny, nz = cfg.n_xyz
        p = st.positions.clamp(min=0).to(torch.int64)
        cells = torch.stack([p // (ny * nz), (p // nz) % ny, p % nz], dim=-1)
    return {"map_cells": cells[live].cpu(), "map_count": st.obs_count[live].cpu(),
            "map_latent": st.latents[live].cpu(), "overflow": int(st.overflow)}


class Sampler:
    """The frames whose map the check reads, drawn from the seed over all of
    a run's windows, whatever their length and the port's speed.

    Frame k has a number ``u[k]`` in [0, 1) from the seed and a stratum: the
    traffic's boundary frames (each fusion frame, the frame after it, the
    first frame of each chunk), where the chunked path's own mechanism acts,
    or the rest.  A stratum keeps the frames with ``u[k] < p``, ``p``
    starting at 1; once it holds more than ``cap`` frames, ``p`` halves and
    the frames above it are let go.  So each stratum ends as the frames of
    the whole window with ``u[k]`` under one rate, between ``cap / 2`` and
    ``cap`` of them.  For a kept frame the map the tracker read is copied
    into pinned host buffers made in set-up, by copies queued behind the
    frame's work (frames that read one map share a copy): nothing in the
    window allocates host memory or waits for the card."""

    def __init__(self, seed: int, cap: int, state, fields):
        self.cap, self.fields = cap, fields
        self.u = np.random.default_rng([int(seed), 29]).random(1 << 18)
        self.p = [1.0, 1.0]
        self.kept: List[Dict[int, Optional[dict]]] = [{}, {}]
        self.free = [{f: torch.empty(getattr(state, f).shape, dtype=getattr(state, f).dtype,
                                     pin_memory=getattr(state, f).is_cuda) for f in fields}
                     for _ in range(2 * cap)]
        self.armed = False
        self._by_state: Dict[int, tuple] = {}     # id(tensor) -> (weakref, snap)
        self._users: Dict[int, int] = {}          # id(snap) -> kept frames reading it

    def _u(self, k: int) -> float:
        return float(self.u[k % len(self.u)])

    def keep(self, k: int, state, boundary: bool) -> None:
        """Frame ``k`` reads ``state``'s map; keep it if the draw says so."""
        if not self.armed:
            return
        s = int(boundary)
        if self._u(k) >= self.p[s]:
            return
        kept = self.kept[s]
        kept[k] = None
        while len(kept) > self.cap:
            self.p[s] /= 2
            for j in [j for j in kept if self._u(j) >= self.p[s]]:
                self._release(kept.pop(j))
        if k in kept:
            kept[k] = self._snap(state)

    def _snap(self, state) -> dict:
        t_last = getattr(state, self.fields[-1])
        ref, snap = self._by_state.get(id(t_last), (None, None))
        if ref is None or ref() is not t_last:
            snap = self.free.pop()
            for f in self.fields:
                snap[f].copy_(getattr(state, f), non_blocking=True)
            self._by_state[id(t_last)] = (weakref.ref(t_last), snap)
        self._users[id(snap)] = self._users.get(id(snap), 0) + 1
        return snap

    def _release(self, snap: Optional[dict]) -> None:
        if snap is None:
            return
        self._users[id(snap)] -= 1
        if self._users[id(snap)] == 0:
            del self._users[id(snap)]
            self._by_state = {k: v for k, v in self._by_state.items() if v[1] is not snap}
            self.free.append(snap)

    @property
    def snaps(self) -> Dict[int, dict]:
        return {**self.kept[0], **self.kept[1]}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    """Set-up, one measured window, and what the window produced."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device,
                 spans: Spans):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.spans = spans
        self.lap = render_lap(cfg, seed, device, every=self.every_rendered())
        self.window_frames: range = range(0)
        self.first_window_frame: Optional[int] = None
        self.window_s = 0.0

    def every_rendered(self) -> int:
        """The stream frames the traffic reads: every ``n``-th."""
        return 1

    def _window_opens(self, first: int) -> None:
        if self.first_window_frame is None:
            self.first_window_frame = first

    @property
    def attempted(self) -> range:
        """Every frame (or extract) of the run's windows."""
        if self.first_window_frame is None:
            return range(0)
        return range(self.first_window_frame, self.window_frames.stop)

    def served(self) -> dict:
        raise NotImplementedError

    def counters(self) -> Dict[str, int]:
        """Counts read around a traced window (reading waits for the card)."""
        raise NotImplementedError


class _Tracking(Driver):
    """The tracker's device-counted loop passes, by GN group."""

    def counters(self) -> Dict[str, int]:
        progs = list(self.system.tracker.programs.values())
        passes = progs[0].program.loop_passes() if progs and progs[0].program else []
        loops = [p for p, (_, done) in zip(passes, progs[0].program._segments)
                 if done is not None] if passes else []
        groups = self.system.tracker.tcfg.iter_config
        out = {"gn_evals": sum(loops), "sdf_evals": 0}
        for n_pass, (_, terms) in zip(loops, groups):
            if any(t[0] == "sdf" for t in terms):
                out["sdf_evals"] += n_pass
        return out


class ChunkDriver(_Tracking):
    """``run_sequence(chunk=K)``, meshing off.  Each chunk's energies come
    from the port's ``track_fuse_scan``, which ``process_chunk`` calls and
    whose third output it drops; a wrapper keeps them."""

    def __init__(self, *a):
        super().__init__(*a)
        import difusion_tpu_torch.slam as slam_mod
        self.K = int(self.traffic["chunk"])
        self.system, self.calib = build_system(self.cfg, self.device, meshing=False)
        self.system.first_iso = gt_pose(self.lap, 0)
        self.energies: List[torch.Tensor] = []
        self.sampler = Sampler(self.seed, int(self.traffic["samples"]) // 2,
                               self.system.state, self.system._map_mod.TRACKED_FIELDS)
        original = self._original = slam_mod.track_fuse_scan
        every = int(self.cfg["integrate_interval"])

        def keeping(tracker, encoder, state, packed_chunk, do_integrate, *a, **k):
            start = tracker.n_tracked
            carry, outs = original(tracker, encoder, state, packed_chunk, do_integrate,
                                   *a, **k)
            self.energies.append(outs[2])
            fused = False
            for j, fuse in enumerate(do_integrate):
                boundary = j == 0 or (start + j) % every in (0, 1)
                self.sampler.keep(start + j, carry.state if fused else state, boundary)
                fused = fused or fuse
            return carry, outs
        slam_mod.track_fuse_scan = keeping
        self.spans.wrap(self.system, "process_chunk")
        self.spans.wrap(self.system, "run_sequence")
        warm = int(self.traffic["warm_frames"])
        self.system.run_sequence(LapStream(self.lap, self.calib, 0, warm), chunk=self.K)
        _sync(self.device)
        self.sampler.armed = True

    def window(self, seconds: float) -> Dict[str, float]:
        first = self.system.tracker.n_tracked
        self._window_opens(first)
        t0 = time.perf_counter()
        stream = LapStream(self.lap, self.calib, first, deadline=t0 + seconds, step=self.K)
        out = self.system.run_sequence(stream, chunk=self.K)
        _sync(self.device)
        self.window_s = time.perf_counter() - t0
        n = int(out["n_frames"])
        self.window_frames = range(first, first + n)
        self.t0 = t0
        return {"frame_ms": 1e3 * self.window_s / n, "frames": n}

    def served(self) -> dict:
        Rs, ts = self.system.tracker.pose_history()
        # frame 0 takes its given pose; every later frame went through a chunk
        E = torch.cat(self.energies).double().cpu().numpy()
        E = np.concatenate([[np.nan], E])
        return {"R": Rs.double().cpu().numpy(), "t": ts.double().cpu().numpy(),
                "E": E, "lap": self.lap, "snapshots": self.sampler.snaps,
                **map_arrays(self.system)}

    def free(self) -> None:
        import difusion_tpu_torch.slam as slam_mod
        slam_mod.track_fuse_scan = self._original
        del self.system


class FrameDriver(_Tracking):
    """``process_frame`` one frame at a time, synchronous meshing on the
    fusion frames.  The latency of frame k: from the call with its arrays to
    its pose read on the host."""

    def __init__(self, *a):
        super().__init__(*a)
        self.system, self.calib = build_system(self.cfg, self.device,
                                               meshing=bool(self.traffic["meshing"]))
        self.system.first_iso = gt_pose(self.lap, 0)
        self.spans.wrap(self.system, "process_frame")
        self.sampler = Sampler(self.seed, int(self.traffic["samples"]) // 2,
                               self.system.state, self.system._map_mod.TRACKED_FIELDS)
        self.every = int(self.cfg["integrate_interval"])
        self.k = 0
        cap = 1 << 16
        self.E = torch.full((cap,), float("nan"), device=self.device, dtype=torch.float64)
        self.latency: Dict[int, float] = {}
        for _ in range(int(self.traffic["warm_frames"])):
            self._one()
        _sync(self.device)
        self.sampler.armed = True

    def _one(self) -> float:
        from difusion_tpu_torch.data.production import FrameData
        rgb, depth = self.lap.frame(self.k)
        frame = FrameData(rgb, depth, None, self.calib, None, self.k)
        self.sampler.keep(self.k, self.system.state, self.k % self.every in (0, 1))
        t0 = time.perf_counter()
        pose = self.system.process_frame(frame, driver="program")
        if self.k > 0:
            prog = next(iter(self.system.tracker.programs.values()))
            self.E[self.k:self.k + 1].copy_(prog.out[12:13])
        pose.t.cpu()
        dt = time.perf_counter() - t0
        self.latency[self.k] = dt
        self.k += 1
        return dt

    def window(self, seconds: float) -> Dict[str, float]:
        first = self.k
        self._window_opens(first)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            self._one()
        _sync(self.device)
        self.window_s = time.perf_counter() - t0
        self.t0 = t0
        self.window_frames = range(first, self.k)
        lat = np.array([self.latency[k] for k in self.window_frames])
        fuse = np.array([k % self.every == 0 for k in self.window_frames])
        return {"frame_ms": 1e3 * self.window_s / len(lat),
                "frame_ms_p99": 1e3 * float(np.percentile(lat, 99)),
                "frames": len(lat),
                "tracked_ms_median": 1e3 * float(np.median(lat[~fuse])),
                "tracked_ms_p99": 1e3 * float(np.percentile(lat[~fuse], 99)),
                "fusion_ms_median": 1e3 * float(np.median(lat[fuse])) if fuse.any() else 0.0,
                "in_frames_share": float(lat.sum() / self.window_s)}

    def served(self) -> dict:
        Rs, ts = self.system.tracker.pose_history()
        out = {"R": Rs.double().cpu().numpy(), "t": ts.double().cpu().numpy(),
               "E": self.E[:self.k].cpu().numpy(), "lap": self.lap,
               "snapshots": self.sampler.snaps,
               **map_arrays(self.system)}
        mesher = self.system.mesher
        if mesher is not None:
            # each cached triangle with the cell of the slot it was meshed for
            st = self.system.state
            slot = torch.as_tensor(mesher._slot, device=self.device)
            if self.system.is_hash:
                cell = st.slot_cell[slot].to(torch.int64)
            else:
                nx, ny, nz = self.system.map_cfg.n_xyz
                p = st.positions[slot].to(torch.int64)
                cell = torch.stack([p // (ny * nz), (p // nz) % ny, p % nz], dim=-1)
            out["last_mesh"] = (cell.cpu(), torch.as_tensor(mesher.triangles()[0]))
        return out

    def free(self) -> None:
        del self.system


class ExportDriver(Driver):
    """Mapping only, then full extracts as ``mesh_tool`` runs them.  Only
    the fusion frames are rendered: nothing else is read."""

    def every_rendered(self) -> int:
        return int(self.cfg["integrate_interval"])

    def __init__(self, *a):
        super().__init__(*a)
        from difusion_tpu_torch.core.meshing import HashMeshExtractor, MeshExtractor
        from difusion_tpu_torch.data.production import FrameData
        self.system, self.calib = build_system(self.cfg, self.device, meshing=False)
        self.system.use_gt_poses = True
        self.system.integrate_interval = 1          # every frame fed is fused
        every = int(self.cfg["integrate_interval"])
        self.fused = list(range(0, len(self.lap), every))
        for k in self.fused:
            rgb, depth = self.lap.frame(k)
            self.system.process_frame(FrameData(rgb, depth, None, self.calib,
                                                gt_pose(self.lap, k), k))
        cls = HashMeshExtractor if self.system.is_hash else MeshExtractor
        self.mesher = cls(self.system.map_cfg, self.system.decoder,
                          voxel_resolution=int(self.traffic["resolution"]),
                          max_triangles=int(self.traffic["max_triangles"]))
        self.spans.wrap(self.mesher, "extract")
        self.max_std = float(self.traffic["max_std"])
        self.n = 0
        self._one()                                   # warm-up
        _sync(self.device)

    def _one(self) -> None:
        self.mesher.extract(self.system.state, max_std=self.max_std, no_cache=True)
        self.n += 1

    def window(self, seconds: float) -> Dict[str, float]:
        first = self.n
        self._window_opens(first)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            self._one()
        _sync(self.device)
        self.window_s = time.perf_counter() - t0
        self.t0 = t0
        self.window_frames = range(first, self.n)
        return {"extract_ms": 1e3 * self.window_s / (self.n - first),
                "extracts": self.n - first}

    def counters(self) -> Dict[str, int]:
        return {"extracts": self.n}

    def blocks(self) -> int:
        """Live blocks of the last extract."""
        return int(self.mesher.last_stats.get("blocks", 0))

    def served(self) -> dict:
        tris, _ = self.mesher.triangles()
        return {"tris": tris, "lap": self.lap, "fused": self.fused,
                **map_arrays(self.system)}

    def free(self) -> None:
        del self.system, self.mesher


DRIVERS = {"chunk": ChunkDriver, "frame": FrameDriver, "export": ExportDriver}
