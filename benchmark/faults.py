"""Faults planted in the port's timed path, each of which the check has to
read as not correct: the tests (``tests/test_bench_cells.py``) plant them at
a tiny size on the CPU, and ``python3 -m benchmark.control --fault <name>``
reads what they give at a cell's own size on the card.

A fault is planted through a :class:`Patch` (pytest's ``monkeypatch`` does
as well) before the cell's driver is built, and undone after.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


class Patch:
    """``setattr`` that remembers what it replaced; :meth:`undo` puts it
    back."""

    def __init__(self):
        self._saved = []

    def setattr(self, obj, name: str, value) -> None:
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self) -> None:
        while self._saved:
            obj, name, value = self._saved.pop()
            setattr(obj, name, value)


def _modules():
    import difusion_tpu_torch.core.hash_map as hash_map
    import difusion_tpu_torch.core.map as dense_map
    import difusion_tpu_torch.core.meshing as meshing
    import difusion_tpu_torch.core.tracker as tracker
    import difusion_tpu_torch.ops.marching_cubes as mc
    import difusion_tpu_torch.slam as slam
    return tracker, slam, dense_map, hash_map, meshing, mc


# -- the tracker ---------------------------------------------------------------

def state_unchanged(mp) -> None:
    """Every Gauss-Newton step returns the pose it was given."""
    tracker = _modules()[0]

    def still(xi):
        return tracker.Pose(torch.eye(3, dtype=xi.dtype, device=xi.device),
                            torch.zeros(3, dtype=xi.dtype, device=xi.device))
    mp.setattr(tracker, "exp_twist", still)


def half_the_points(mp) -> None:
    """The SDF term sums over the first half of the points only."""
    tracker = _modules()[0]
    original = tracker._sdf_term

    def half(map_cfg, packed, state, last, delta, pts, mask, *a, **k):
        n = pts.shape[0] // 2
        return original(map_cfg, packed, state, last, delta, pts[:n], mask[:n], *a, **k)
    mp.setattr(tracker, "_sdf_term", half)


def answer_altered(mp) -> None:
    """Every served pose moved 3 mm where the program writes it."""
    tracker = _modules()[0]
    original = tracker.TrackProgram._finish

    def finish(self):
        original(self)
        self.out[9:10].add_(0.003)
    mp.setattr(tracker.TrackProgram, "_finish", finish)


def _served_as_previous(mp, hit: Callable[[int, int], bool]) -> None:
    """The frames that ``hit(frame, first frame of its chunk or None)`` picks are
    served the previous frame's pose: a step that returned its state
    unchanged, on those frames only.  The chunked path (``track_fuse_scan``)
    and the per-frame path (``track_camera_packed``) both."""
    tracker, slam = _modules()[:2]
    scan = slam.track_fuse_scan

    def scan_fault(tr, encoder, state, packed_chunk, do_integrate, *a, **k):
        start = tr.n_tracked
        prev = (tr.last_pose.R.clone(), tr.last_pose.t.clone())
        carry, (Rs, ts, E) = scan(tr, encoder, state, packed_chunk, do_integrate, *a, **k)
        for j in range(Rs.shape[0]):
            here = (Rs[j].clone(), ts[j].clone())
            if hit(start + j, start):
                Rs[j].copy_(prev[0])
                ts[j].copy_(prev[1])
            prev = here
        return carry, (Rs, ts, E)
    mp.setattr(slam, "track_fuse_scan", scan_fault)

    one = tracker.SDFTracker.track_camera_packed

    def one_fault(self, state, packed, w, set_pose=None, driver=None):
        prev = (None if self.n_tracked == 0 else
                (self.last_pose.R.clone(), self.last_pose.t.clone()))
        pose = one(self, state, packed, w, set_pose, driver=driver)
        k = self.n_tracked - 1
        if set_pose is None and prev is not None and hit(k, None):
            pose.R.copy_(prev[0])
            pose.t.copy_(prev[1])
        return pose
    mp.setattr(tracker.SDFTracker, "track_camera_packed", one_fault)


def chunk_first_unchanged(mp) -> None:
    """The first frame of each chunk is served the previous frame's pose
    (the chunked path only)."""
    _served_as_previous(mp, lambda k, first: first is not None and k == first)


def fusion_frames_unchanged(mp, every: int = 20) -> None:
    """The fusion frames (every ``every``-th) are served the previous
    frame's pose."""
    _served_as_previous(mp, lambda k, first: k % every == 0)


# -- the map -------------------------------------------------------------------

def drop_one_fusion(mp, which: int = 2) -> None:
    """The ``which``-th fusion (counting from 1) leaves the map as it was:
    one keyframe dropped, on the dense map and the hash map alike."""
    dense_map, hash_map = _modules()[2:4]
    calls = [0]
    for mod in (dense_map, hash_map):
        original = mod.integrate_keyframe

        def integrate(cfg, encoder, state, *a, _original=original, **k):
            calls[0] += 1
            if calls[0] == which:
                return state
            return _original(cfg, encoder, state, *a, **k)
        mp.setattr(mod, "integrate_keyframe", integrate)


def map_unchanged(mp) -> None:
    """No fusion changes the map."""
    dense_map, hash_map = _modules()[2:4]
    for mod in (dense_map, hash_map):
        mp.setattr(mod, "integrate_keyframe", lambda cfg, enc, state, *a, **k: state)


# -- the offline mesher ----------------------------------------------------------

def half_the_blocks(mp) -> None:
    """The export meshes every other live block."""
    meshing = _modules()[4]
    original = meshing._mesh_prep_dense

    def prep(cfg, state, no_cache):
        cells, slots = original(cfg, state, no_cache)
        return cells[::2], slots[::2]
    mp.setattr(meshing, "_mesh_prep_dense", prep)


def vertices_moved(mp) -> None:
    """Every vertex of the export moved 1 cm where marching cubes writes
    it."""
    meshing, mc = _modules()[4:6]
    original = mc.mc_triangles_np

    def unpack(res):
        tris, stds, blocks, total = original(res)
        return tris + 0.01, stds, blocks, total
    mp.setattr(meshing, "mc_triangles_np", unpack)


TRACKING: Dict[str, Callable] = {
    "state_unchanged": state_unchanged,
    "half_the_points": half_the_points,
    "answer_altered": answer_altered,
    "fusion_frames_unchanged": fusion_frames_unchanged,
    "drop_one_fusion": drop_one_fusion,
}
CHUNK: Dict[str, Callable] = {**TRACKING, "chunk_first_unchanged": chunk_first_unchanged}
EXPORT: Dict[str, Callable] = {
    "map_unchanged": map_unchanged,
    "half_the_blocks": half_the_blocks,
    "answer_altered": vertices_moved,
    "drop_one_fusion": drop_one_fusion,
}
BY_ENTRY = {"chunk": CHUNK, "frame": TRACKING, "export": EXPORT}
