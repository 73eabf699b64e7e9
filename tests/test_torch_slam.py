"""The port's slices as a whole against the JAX package on the CPU: the
same 6-frame 120x160 synthetic sequence tracked, fused and meshed by both
SLAMSystems (meshing on, the JAX package's default) with the in-repo
prior."""
from pathlib import Path

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

from difusion_tpu.core import map as JM
from difusion_tpu.core import tracker as JT
from difusion_tpu.data import SyntheticSequence as JSequence
from difusion_tpu.data.production import mesh_error_stats as jax_mesh_error_stats
from difusion_tpu.ops.imgproc import Intrinsic as JIntrinsic
from difusion_tpu.slam import SLAMSystem as JSLAMSystem
from difusion_tpu.slam import load_prior as jax_load_prior
from difusion_tpu.utils.motion import ate_rmse as jax_ate_rmse
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core import tracker as T
from difusion_tpu_torch.data.production import SyntheticSequence, mesh_error_stats
from difusion_tpu_torch.ops.imgproc import Intrinsic
from difusion_tpu_torch.slam import SLAMSystem, load_prior
from difusion_tpu_torch.utils.motion import ate_rmse

HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"
CALIB = (300.0, 300.0, 79.5, 59.5, 5000.0)
SEQ = dict(n_frames=6, h=120, w=160, corrugation=0.1, motion_scale=0.6)
MAP = dict(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
           latent_dim=29, capacity=1 << 14, prune_min_vox_obs=4,
           ignore_count_th=1.0, encoder_count_th=600.0)
ITERS = ((3, (("rgb", 2),)), (3, (("sdf",), ("rgb", 1))),
         (6, (("sdf",), ("rgb", 0))))


@pytest.fixture(scope="module")
def runs():
    """Per-frame poses (R, t) of both packages, and both systems (each
    meshes at r = 4 on every fusion frame)."""
    dec, enc, spec = jax_load_prior(str(HYPER), 300)
    jsys = JSLAMSystem(JM.MapConfig(**MAP),
                       JT.TrackerConfig(point_budget=4096, warp_tiled=False,
                                        iter_config=ITERS),
                       dec, enc, spec, JIntrinsic(*CALIB), integrate_interval=2)
    jseq = JSequence(calib=JIntrinsic(*CALIB), **SEQ)
    for frame in jseq:
        jsys.process_frame(frame)
    jposes = jsys.tracker.all_pd_pose

    t_dec, t_enc, _ = load_prior(HYPER, 300, device="cpu")
    tsys = SLAMSystem(M.MapConfig(**MAP),
                      T.TrackerConfig(point_budget=4096, iter_config=ITERS),
                      t_dec, t_enc, Intrinsic(*CALIB), integrate_interval=2,
                      device="cpu")
    tseq = SyntheticSequence(calib=Intrinsic(*CALIB), **SEQ)
    frames = list(tseq)
    for frame in frames:
        tsys.process_frame(frame)
    return jseq, jposes, tseq, frames, tsys, jsys


def test_synthetic_sequence_matches_jax(runs):
    """The port's renderer and trajectory reproduce the JAX package's
    frames and GT exactly (same numpy arithmetic)."""
    jseq, _, tseq, frames, *_ = runs
    ref = JSequence(calib=JIntrinsic(*CALIB), **SEQ)
    for frame, jframe in zip(frames, ref):
        np.testing.assert_array_equal(frame.rgb, jframe.rgb)
        np.testing.assert_array_equal(frame.depth, jframe.depth)
    for a, b in zip(tseq.gt_trajectory, jseq.gt_trajectory):
        np.testing.assert_allclose(a.q.rotation_matrix, b.q.rotation_matrix,
                                   atol=1e-12)
        np.testing.assert_allclose(a.t, b.t, atol=1e-12)


def test_slice_poses_match_jax(runs):
    """Per-frame poses within 1e-4 m and 1e-4 rad of the JAX package's
    (per-pixel warp, fusion every 2 frames, a short GN schedule).  The
    packages agree bit for bit up to the point cloud and the map's integer
    state; what remains is f32 summation order in the GN normal equations."""
    _, jposes, _, _, tsys, _ = runs
    tposes = tsys.tracker.all_pd_pose
    assert len(tposes) == len(jposes) == SEQ["n_frames"]
    for k, (a, b) in enumerate(zip(tposes, jposes)):
        assert np.abs(a.t - b.t).max() < 1e-4, (k, a.t, b.t)
        dR = a.q.rotation_matrix.T @ b.q.rotation_matrix
        angle = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert angle < 1e-4, (k, angle)


def test_slice_tracks_and_fuses(runs):
    """The port tracks the noise-free sequence to ~1 mm ATE, fuses voxels,
    and on the CPU the host waits for at most one exit flag per GN
    evaluation, n + 1 a group (``n_host_syncs`` counts the flags the host
    waited for; the captured program on the card reads none,
    tests/test_torch_cuda_kernels.py)."""
    jseq, jposes, tseq, _, tsys, _ = runs
    ate = ate_rmse(tseq.gt_trajectory, tsys.tracker.all_pd_pose)
    assert ate < 5e-3, ate
    assert abs(ate - jax_ate_rmse(jseq.gt_trajectory, jposes)) < 1e-4
    assert int(tsys.state.n_occupied) > 100
    n_evals = sum(n + 1 for n, _ in ITERS) * (SEQ["n_frames"] - 1)
    assert 0 < tsys.tracker.n_host_syncs <= n_evals


def test_slice_meshes_like_jax(runs):
    """The incremental meshes after the last fusion: triangle counts within
    0.5% and the 95th-percentile distance to the analytic surface within
    1e-3 m of the JAX package's, and below 0.02 m.  Tolerances, not exact
    counts: fused latents differ at rtol 1e-5, so a corner near zero can
    flip a cube."""
    *_, tsys, jsys = runs
    tt, _ = tsys.mesher.triangles()
    jt, _ = jsys.mesher.triangles()
    assert len(jt) > 1000
    assert abs(len(tt) - len(jt)) <= 0.005 * len(jt), (len(tt), len(jt))
    t_err = mesh_error_stats(tt)["mesh_err_p95"]
    j_err = jax_mesh_error_stats(jt)["mesh_err_p95"]
    assert abs(t_err - j_err) < 1e-3 and t_err < 0.02, (t_err, j_err)
    assert np.isfinite(tt).all()


def test_slam_rejects_unported_options():
    """The mesher's fast mode, the optimizer and the tracker's modes are
    ported (they build); an unknown optimizer mode and a tracker value
    outside the JAX package's raise."""
    t_dec, t_enc, _ = load_prior(HYPER, 300, device="cpu")
    args = (M.MapConfig(**MAP), T.TrackerConfig(), t_dec, t_enc, Intrinsic(*CALIB))
    assert SLAMSystem(*args, mesh_fast=True, device="cpu").mesher.fast
    assert SLAMSystem(*args, latent_optimize=True, device="cpu").latent_optimize
    with pytest.raises(ValueError):
        SLAMSystem(*args, latent_optimize=True, latent_optimize_mode="async",
                   device="cpu")
    assert SLAMSystem(*args[:1], T.TrackerConfig(warp_tiled=True), *args[2:],
                      device="cpu").tracker.tcfg.warp_tiled
    with pytest.raises(NotImplementedError):
        SLAMSystem(*args[:1], T.TrackerConfig(sdf_compute_dtype="float16"), *args[2:],
                   device="cpu")
