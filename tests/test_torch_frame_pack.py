"""The frame's packed buffer made from the camera's raw arrays
(``ops/frame_pack.py``) on the CPU, where :func:`frame_pack` runs its plain
version: byte for byte the JAX package's ``pack_frame`` (and the port's
numpy copy of it), through the staging buffer the SLAM loop uses; poses of
the SLAM loop equal to the numpy route's; float frames and the lossless
packing still packed by numpy.  The kernel itself is held to the plain
version on the card (``test_torch_cuda_kernels.py``)."""
from pathlib import Path

import numpy as np
import pytest
import torch

from difusion_tpu.core import tracker as JT
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core import tracker as T
from difusion_tpu_torch.data.production import FrameData, SyntheticSequence
from difusion_tpu_torch.ops import frame_pack as FP
from difusion_tpu_torch.ops.imgproc import Intrinsic
from difusion_tpu_torch.slam import SLAMSystem, load_prior
from difusion_tpu_torch.utils import tracing

HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"
CALIB = (300.0, 300.0, 79.5, 59.5, 5000.0)
MAP = dict(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
           latent_dim=29, capacity=1 << 14, prune_min_vox_obs=4,
           ignore_count_th=1.0, encoder_count_th=600.0)
ITERS = ((3, (("rgb", 2),)), (3, (("sdf",), ("rgb", 1))),
         (6, (("sdf",), ("rgb", 0))))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(kind, k, h, w, seed):
    """K (rgb, depth) pairs: random, or one of the edge cases."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (k, h, w, 3), dtype=np.uint8)
    depth = rng.integers(0, 1 << 16, (k, h, w), dtype=np.uint16)
    if kind == "black":
        rgb[:] = 0
    elif kind == "white":
        rgb[:] = 255
    elif kind == "depth_edges":
        depth[:] = np.resize(np.array([0, 255, 256, 65535, 1, 257, 65280], np.uint16),
                             depth.shape)
    elif kind == "sums":              # every r + g + b from 0 to 765
        s = np.arange(h * w * k) % 766
        rgb[..., 0] = np.minimum(s, 255).reshape(k, h, w)
        rgb[..., 1] = np.clip(s - 255, 0, 255).reshape(k, h, w)
        rgb[..., 2] = np.clip(s - 510, 0, 255).reshape(k, h, w)
    frames = [(rgb[i], depth[i]) for i in range(k)]
    if kind == "strided":             # views of larger arrays, read-only
        big = rng.integers(0, 256, (k, 2 * h, w + 3, 4), dtype=np.uint8)
        bigd = rng.integers(0, 1 << 16, (k, h, 2 * w), dtype=np.uint16)
        frames = [(big[i, ::2, 1:w + 1, :3], bigd[i, :, ::2]) for i in range(k)]
        for a, b in frames:
            a.flags.writeable = False
            b.flags.writeable = False
    elif kind == "fortran":
        frames = [(np.asfortranarray(a), np.asfortranarray(b)) for a, b in frames]
    return frames


CASES = [("random", 1, 48, 64), ("random", 12, 24, 32), ("random", 3, 7, 5),
         ("random", 2, 1, 1), ("random", 1, 5, 13), ("black", 2, 6, 8),
         ("white", 2, 6, 8), ("depth_edges", 1, 7, 9), ("depth_edges", 12, 4, 16),
         ("sums", 1, 30, 26), ("strided", 3, 9, 11), ("strided", 12, 4, 8),
         ("fortran", 2, 5, 7)]


@pytest.mark.parametrize("kind,k,h,w", CASES, ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}"
                                                   for c in CASES])
def test_plain_pack_equals_pack_frame(kind, k, h, w):
    """Staged in one buffer and packed by the plain version: the (K, h, 3w)
    planes equal the JAX package's ``pack_frame`` of each frame, as the
    port's numpy ``pack_frame`` does, at odd widths, K = 1 and 12, edge
    values and non-contiguous, read-only or Fortran-ordered arrays."""
    frames = _frames(kind, k, h, w, seed=k * 1000 + h * 10 + w)
    assert all(FP.takes(rgb, depth, lossless=False) for rgb, depth in frames)
    staged = FP.RawFrames(k, h, w, pin=False)
    for i, (rgb, depth) in enumerate(frames):
        staged.put(i, rgb, depth)
    got = staged.pack("cpu").numpy()
    ref = np.stack([JT.pack_frame(rgb, depth, CALIB[4]) for rgb, depth in frames])
    assert got.shape == (k, h, 3 * w) and got.dtype == np.uint8
    assert np.array_equal(got, ref)
    assert np.array_equal(np.stack([T.pack_frame(rgb, depth, CALIB[4])
                                    for rgb, depth in frames]), ref)
    # the first n frames alone, as a chunk's tail packs them
    assert np.array_equal(staged.pack("cpu", 1).numpy(), ref[:1])


def test_takes_only_camera_arrays():
    """uint8 (h, w, 3) RGB with uint16 (h, w) depth, packed quantized."""
    rgb = np.zeros((4, 5, 3), np.uint8)
    depth = np.zeros((4, 5), np.uint16)
    assert FP.takes(rgb, depth, lossless=False)
    assert not FP.takes(rgb, depth, lossless=True)
    assert not FP.takes(rgb.astype(np.float32) / 255, depth, lossless=False)
    assert not FP.takes(rgb, depth.astype(np.float32), lossless=False)
    assert not FP.takes(rgb[..., :1], depth, lossless=False)
    assert not FP.takes(rgb, depth[:3], lossless=False)
    assert not FP.takes(rgb, depth.astype(">u2"), lossless=False)
    assert not FP.takes(torch.from_numpy(rgb), torch.from_numpy(depth.view(np.int16)),
                        lossless=False)


@pytest.fixture(scope="module")
def make():
    dec, enc, _ = load_prior(HYPER, 300, device="cpu")

    def make(lossless=False, meshing=True):
        return SLAMSystem(M.MapConfig(**MAP),
                          T.TrackerConfig(point_budget=4096, iter_config=ITERS,
                                          lossless_packing=lossless),
                          dec, enc, Intrinsic(*CALIB), integrate_interval=2,
                          mesh_resolution=3, meshing=meshing, device="cpu")
    return make


def _sequence(n):
    return SyntheticSequence(n_frames=n, h=120, w=160, calib=Intrinsic(*CALIB),
                             corrugation=0.1, motion_scale=0.6)


class _Spy:
    """Counts the calls of the two packs while a test runs."""

    def __init__(self, monkeypatch):
        self.numpy = self.raw = 0
        numpy_pack, raw_pack = T.pack_frame, FP.frame_pack

        def counted_numpy(*a, **k):
            self.numpy += 1
            return numpy_pack(*a, **k)

        def counted_raw(*a, **k):
            self.raw += 1
            return raw_pack(*a, **k)
        monkeypatch.setattr(T, "pack_frame", counted_numpy)
        monkeypatch.setattr(FP, "frame_pack", counted_raw)


def test_process_frame_equals_the_numpy_packed_frame(make, monkeypatch):
    """``process_frame(frame)`` packs from the raw arrays, once a frame, and
    tracks, fuses and meshes as ``process_frame(frame, packed=<numpy
    pack>)``: equal poses, latents and triangles over five frames, three of
    them fusion frames."""
    frames = list(_sequence(5))
    spy = _Spy(monkeypatch)
    a, b = make(), make()
    for frame in frames:
        a.process_frame(frame)
    assert (spy.raw, spy.numpy) == (len(frames), 0)
    for frame in frames:
        b.process_frame(frame, packed=torch.from_numpy(
            T.pack_frame(frame.rgb, frame.depth, CALIB[4])))
    for x, y in zip(a.tracker.pose_history(), b.tracker.pose_history()):
        assert torch.equal(x, y)
    assert torch.equal(a.state.latents, b.state.latents)
    assert np.array_equal(a.mesher.triangles()[0], b.mesher.triangles()[0])


class _Frames(list):
    """A list of frames as a sequence (``first_iso``, ``gt_trajectory``)."""
    first_iso = None
    gt_trajectory = None


def _floats(frame):
    return FrameData(frame.rgb.astype(np.float32) * np.float32(1 / 255),
                     frame.depth.astype(np.float32) / np.float32(CALIB[4]), frame.depth_ok,
                     frame.calib, frame.gt_pose, frame.frame_id)


@pytest.mark.parametrize("route", ["float", "lossless"])
@pytest.mark.parametrize("path", ["frame", "chunk"])
def test_float_frames_and_lossless_packing_pack_in_numpy(make, monkeypatch, route, path):
    """Float RGB or depth, or ``lossless_packing``, keep numpy's
    ``pack_frame``: one numpy pack a frame and no raw pack, on the
    per-frame path and through the feeder."""
    frames = _Frames(_sequence(4))
    if route == "float":
        frames = _Frames(_floats(f) for f in frames)
    system = make(lossless=route == "lossless", meshing=False)
    spy = _Spy(monkeypatch)
    if path == "frame":
        for frame in frames:
            system.process_frame(frame)
    else:
        system.run_sequence(frames, chunk=3)
    assert (spy.raw, spy.numpy) == (0, len(frames))
    assert len(system.tracker.pose_history()[0]) == len(frames)


@pytest.mark.parametrize("chunk", [0, 3])
def test_run_sequence_packs_raw_frames_once_an_upload(make, monkeypatch, chunk):
    """``run_sequence`` over 8 uint8 / uint16 frames: one raw pack an upload
    (frame 0 alone, then chunks of 1 + 3 + 3 + 1 frames, or each frame
    alone), no numpy pack, a ``slam.feed.pack`` span a frame and a
    ``slam.feed.upload`` span an upload but no ``slam.feed.stack``, and poses
    and latents equal to the numpy route's (the feeder then packs with
    numpy and stacks)."""
    frames = _Frames(_sequence(8))
    spy = _Spy(monkeypatch)
    a = make(meshing=False)
    tracing.enable()
    try:
        a.run_sequence(frames, chunk=chunk)
    finally:
        tracing.disable()
    spans = tracing.spans()
    tracing.reset()
    uploads = [0, 1, 4, 7] if chunk else list(range(8))
    assert (spy.raw, spy.numpy) == (len(uploads), 0)
    assert sorted(s.item for s in spans if s.name == "slam.feed.pack") == list(range(8))
    assert sorted(s.item for s in spans if s.name == "slam.feed.upload") == uploads
    assert not [s for s in spans if s.name == "slam.feed.stack" or s.wait]
    monkeypatch.setattr(FP, "takes", lambda *a, **k: False)
    b = make(meshing=False)
    b.run_sequence(frames, chunk=chunk)
    assert spy.numpy == len(frames)
    for x, y in zip(a.tracker.pose_history(), b.tracker.pose_history()):
        assert torch.equal(x, y)
    assert torch.equal(a.state.latents, b.state.latents)


def test_feeder_raises_where_a_later_frame_leaves_the_camera_route(make, monkeypatch):
    """The call's first frame chooses the route: after uint8 / uint16
    frames, a float frame raises from ``run_sequence``; a call that starts
    on float frames packs every frame in numpy, uint8 ones too."""
    frames = _Frames(_sequence(6))
    mixed = _Frames(frames)
    mixed[4] = _floats(frames[4])
    with pytest.raises(ValueError, match="frame 4 is not the camera's uint8 RGB"):
        make(meshing=False).run_sequence(mixed, chunk=3)
    floats_first = _Frames(frames)
    floats_first[0] = _floats(frames[0])
    system = make(meshing=False)
    spy = _Spy(monkeypatch)
    system.run_sequence(floats_first, chunk=3)
    assert (spy.raw, spy.numpy) == (0, len(frames))
    assert len(system.tracker.pose_history()[0]) == len(frames)
