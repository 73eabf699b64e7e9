"""The port's raw-array tracking entry (``core/tracker.preprocess_frame``,
``SDFTracker.track_camera``) against the JAX package's on
tests/test_tracker.py's 120x160 surface frames, small map and in-repo
prior: (a) preprocessing of uint8 rgb with f32 and with uint16 depth, (b)
the float path bit-equal to the lossless packed path, (c) two tracked
frames (the first at a set pose, a fusion between) against the JAX
``track_camera`` and the true motion, on both drivers."""
from pathlib import Path

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import jax.numpy as jnp
import torch

from difusion_tpu.core import map as JM
from difusion_tpu.core import tracker as JT
from difusion_tpu.slam import load_prior as jax_load_prior
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core import tracker as T
from difusion_tpu_torch.models.weights import load_prior
from difusion_tpu_torch.ops.imgproc import Intrinsic
from difusion_tpu_torch.utils.motion import Isometry
from test_tracker import CALIB, render_surface_frame, small_cfg

HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"
TRUE_DELTA = np.array([0.01, -0.008, 0.012, 0.004, -0.003, 0.005])
# the GN schedule of tests/test_torch_slam.py (the default's 70 updates per
# frame take minutes on the CPU for both packages)
ITERS = ((3, (("rgb", 2),)), (3, (("sdf",), ("rgb", 1))), (6, (("sdf",), ("rgb", 0))))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Several workers run the suite at once: two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sensor(pose):
    """A frame as the sensor gives it: uint8 rgb, uint16 depth in
    ``CALIB.dcam_scale`` units, and the f32 arrays they came from."""
    rgb, depth, _ = render_surface_frame(pose, CALIB, corrugation=0.1)
    rgb, depth = np.array(rgb), np.array(depth)
    return ((rgb * 255).astype(np.uint8), (depth * CALIB.dcam_scale).astype(np.uint16),
            rgb, depth)


@pytest.fixture(scope="module")
def frames():
    pose0 = Isometry()
    pose1 = pose0.dot(Isometry.from_twist(TRUE_DELTA))
    return (pose0, _sensor(pose0)), (pose1, _sensor(pose1))


@pytest.mark.parametrize("depth_kind", ["f32", "uint16"])
def test_preprocess_frame_matches_jax(frames, depth_kind):
    """(a) uint8 rgb with f32 or uint16 depth: pyramid planes and points
    within 1e-6, masks equal; normals within 2e-3 (XLA's FMA contraction of
    the JAX stencil on the CPU, ``tests/test_torch_tracker.py::
    test_normal_difference_is_xla_fma_contraction``)."""
    rgb8, d16, _, depth = frames[1][1]
    d = depth if depth_kind == "f32" else d16
    a = JT.preprocess_frame(JT.TrackerConfig(point_budget=4096), CALIB,
                            jnp.asarray(rgb8), jnp.asarray(d))
    b = T.preprocess_frame(T.TrackerConfig(point_budget=4096), Intrinsic(*CALIB), rgb8, d,
                           device="cpu")
    for name in a.pyramid._fields:
        for lvl in range(3):
            got = getattr(b.pyramid, name)[lvl].numpy()
            ref = np.asarray(getattr(a.pyramid, name)[lvl])
            if got.dtype == np.bool_:
                np.testing.assert_array_equal(got, ref)
            else:
                np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(b.pc_mask.numpy(), np.asarray(a.pc_mask))
    assert b.pc_mask.sum() > 1000
    np.testing.assert_allclose(b.pts_cam.numpy(), np.asarray(a.pts_cam), atol=1e-6, rtol=0)
    np.testing.assert_allclose(b.normals_cam.numpy(), np.asarray(a.normals_cam), atol=2e-3)


def test_float_frame_equals_lossless_packed(frames):
    """(b) ``preprocess_frame`` of f32 arrays is ``preprocess_packed`` of
    their lossless pack, bit for bit; ``pack_lossless`` on the tensors is
    ``pack_frame(lossless=True)`` byte for byte, also after the uint8 /
    uint16 conversion."""
    tcfg, calib = T.TrackerConfig(point_budget=4096), Intrinsic(*CALIB)
    rgb8, d16, rgb, depth = frames[1][1]
    direct = T.preprocess_frame(tcfg, calib, rgb, depth, device="cpu")
    packed = T.pack_frame(rgb, depth, calib.dcam_scale, lossless=True)
    via = T.preprocess_packed(tcfg, calib, torch.from_numpy(packed), depth.shape[1])
    for x, y in zip(T._tensors(direct), T._tensors(via)):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(
        T.pack_lossless(torch.from_numpy(rgb), torch.from_numpy(depth)).numpy(), packed)
    rgb_t, depth_t = T.sensor_frame(rgb8, d16, calib.dcam_scale, torch.device("cpu"))
    rgb_n = rgb8.astype(np.float32) * np.float32(1.0 / 255.0)
    depth_n = d16.astype(np.float32) * np.float32(1.0 / calib.dcam_scale)
    np.testing.assert_array_equal(rgb_t.numpy(), rgb_n)
    np.testing.assert_array_equal(depth_t.numpy(), depth_n)
    np.testing.assert_array_equal(T.pack_lossless(rgb_t, depth_t).numpy(),
                                  T.pack_frame(rgb_n, depth_n, calib.dcam_scale,
                                               lossless=True))


@pytest.fixture(scope="module")
def jax_poses(frames):
    """The JAX package's two frames: set pose, fuse, track."""
    dec, enc, spec = jax_load_prior(str(HYPER), 300)
    cfg = small_cfg(prune_min_vox_obs=4, ignore_count_th=1.0)
    tr = JT.SDFTracker(cfg, JT.TrackerConfig(point_budget=4096, warp_tiled=False,
                                             iter_config=ITERS), dec, spec, CALIB)
    (pose0, f0), (_, f1) = frames
    state = JM.create_map_state(cfg)
    p0 = tr.track_camera(state, jnp.asarray(f0[0]), jnp.asarray(f0[1]), set_pose=pose0)
    state = JM.integrate_keyframe(cfg, enc, state, *tr.last_pc_world(p0))
    tr.track_camera(state, jnp.asarray(f1[0]), jnp.asarray(f1[1]))
    return tr.all_pd_pose


@pytest.mark.parametrize("driver", ["host", "program"])
def test_track_camera_matches_jax(frames, jax_poses, driver):
    """(c) Frame 0 at its true pose, fused; frame 1 tracked from uint8 rgb and
    uint16 depth numpy arrays.  The pose within 1e-4 m and 1e-4 rad of the
    JAX package's (``tests/test_torch_slam.py``'s tolerance for a tracked
    frame), and within 1 cm / 0.01 rad of the true pose
    (``tests/test_tracker.py:346-349``); equal to ``track_camera_packed`` on
    the lossless pack of the converted arrays.  On the CPU both drivers run
    the frame's one ``TrackProgram`` uncaptured."""
    dec, enc, _ = load_prior(HYPER, 300, device="cpu")
    cfg = M.MapConfig(**small_cfg(prune_min_vox_obs=4, ignore_count_th=1.0)._asdict())
    tcfg = T.TrackerConfig(point_budget=4096, iter_config=ITERS)
    (pose0, f0), (pose1, f1) = frames
    poses = []
    for packed in (False, True):
        tr = T.SDFTracker(cfg, tcfg, dec, Intrinsic(*CALIB), "cpu")
        state = M.create_map_state(cfg, "cpu")
        if packed:
            def track(state, f, **kw):
                rgb, depth = T.sensor_frame(f[0], f[1], CALIB.dcam_scale,
                                            torch.device("cpu"))
                pk = T.pack_frame(rgb.numpy(), depth.numpy(), CALIB.dcam_scale,
                                  lossless=True)
                return tr.track_camera_packed(state, torch.from_numpy(pk),
                                              f[1].shape[1], driver=driver, **kw)
        else:
            def track(state, f, **kw):
                return tr.track_camera(state, f[0], f[1], driver=driver, **kw)
        p0 = track(state, f0, set_pose=pose0)
        state = M.integrate_keyframe(cfg, enc, state, *tr.last_pc_world(p0))
        track(state, f1)
        poses.append(tr.pose_history())
        assert len(tr.programs) == 1
        assert not next(iter(tr.programs.values())).program.captured
    assert all(torch.equal(a, b) for a, b in zip(*poses))
    got = Isometry.from_matrix(poses[0][0][-1].double().numpy(),
                               poses[0][1][-1].double().numpy(), ortho=True)
    ref = jax_poses[-1]
    assert np.abs(got.t - ref.t).max() < 1e-4, (got.t, ref.t)
    dR = got.q.rotation_matrix.T @ ref.q.rotation_matrix
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 1e-4
    err = got.inv().dot(pose1).log()
    assert np.linalg.norm(err[:3]) < 0.01 and np.linalg.norm(err[3:]) < 0.01, err
