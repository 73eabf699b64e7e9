"""The port's chunked path (``track_fuse_scan`` / ``process_chunk`` /
``run_sequence``) and its per-frame path (``process_frame``, both drivers)
on the CPU: against each other, which they must reproduce exactly, and
against the JAX package at 120x160 with the in-repo prior, on the dense and
the hash map and under each ``solve_dtype``.  On the CPU the tracker's
program runs the same stage functions eagerly that the card replays as one
CUDA graph."""
from pathlib import Path

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from difusion_tpu.core import hash_map as JHM
from difusion_tpu.core import map as JM
from difusion_tpu.core import tracker as JT
from difusion_tpu.data import SyntheticSequence as JSequence
from difusion_tpu.ops.imgproc import Intrinsic as JIntrinsic
from difusion_tpu.slam import SLAMSystem as JSLAMSystem
from difusion_tpu.slam import load_prior as jax_load_prior
from difusion_tpu_torch.core import hash_map as HM
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core import tracker as T
from difusion_tpu_torch.data.production import SyntheticSequence
from difusion_tpu_torch.ops.imgproc import Intrinsic
from difusion_tpu_torch.ops.se3 import Pose
from difusion_tpu_torch.slam import SLAMSystem, load_prior, track_fuse_scan
from difusion_tpu_torch.utils.motion import Isometry

HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"
CALIB = (300.0, 300.0, 79.5, 59.5, 5000.0)
H, W = 120, 160
N = 6                      # frame 0 + a chunk of 5
MAP = dict(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
           latent_dim=29, capacity=1 << 14, prune_min_vox_obs=4,
           ignore_count_th=1.0, encoder_count_th=600.0)
HASH = dict(voxel_size=0.1, latent_dim=29, capacity=1 << 14, table_size=1 << 16,
            prune_min_vox_obs=4, ignore_count_th=1.0, encoder_count_th=600.0)
ITERS = ((3, (("rgb", 2),)), (3, (("sdf",), ("rgb", 1))),
         (6, (("sdf",), ("rgb", 0))))


def _sequence(n=N, cls=SyntheticSequence, intrinsic=Intrinsic):
    return cls(n_frames=n, h=H, w=W, calib=intrinsic(*CALIB), corrugation=0.1,
               motion_scale=0.6)


def _pack(frames):
    return np.stack([T.pack_frame(f.rgb, f.depth, CALIB[4]) for f in frames])


@pytest.fixture(scope="module")
def port():
    """Frames, and a factory of port systems on the CPU (fusion every 2)."""
    dec, enc, _ = load_prior(HYPER, 300, device="cpu")

    def make(hash_map=False, meshing=False, **tracker_kw):
        return SLAMSystem(HM.HashMapConfig(**HASH) if hash_map else M.MapConfig(**MAP),
                          T.TrackerConfig(point_budget=4096, iter_config=ITERS,
                                          **tracker_kw),
                          dec, enc, Intrinsic(*CALIB), integrate_interval=2,
                          meshing=meshing, device="cpu")
    return list(_sequence()), make


@pytest.fixture(scope="module")
def per_frame(port):
    frames, make = port
    system = make()
    for frame in frames:
        system.process_frame(frame)
    return system


@pytest.fixture(scope="module")
def chunked(port):
    """Frame 0 alone, then one chunk of 5."""
    frames, make = port
    system = make()
    system.process_frame(frames[0])
    system.process_chunk(torch.from_numpy(_pack(frames[1:])), W)
    return system


@pytest.fixture(scope="module")
def jax_prior():
    return jax_load_prior(str(HYPER), 300)


def _jax_system(jax_prior, hash_map=False, **tracker_kw):
    dec, enc, spec = jax_prior
    return JSLAMSystem(JHM.HashMapConfig(**HASH) if hash_map else JM.MapConfig(**MAP),
                       JT.TrackerConfig(point_budget=4096, warp_tiled=False,
                                        iter_config=ITERS, **tracker_kw),
                       dec, enc, spec, JIntrinsic(*CALIB), integrate_interval=2,
                       meshing=False)


def _poses(system):
    return [t.numpy() for t in system.tracker.pose_history()]


def _assert_poses_close(got, ref):
    """1e-4 m and 1e-4 rad per pose: the bound of
    tests/test_torch_slam.py::test_slice_poses_match_jax (what remains between
    the packages is f32 summation order in the GN normal equations)."""
    assert len(got) == len(ref)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert np.abs(a.t - b.t).max() < 1e-4, (k, a.t, b.t)
        dR = a.q.rotation_matrix.T @ b.q.rotation_matrix
        angle = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert angle < 1e-4, (k, angle)


def test_program_matches_host_loop_on_one_frame(port, jax_prior):
    """The tracker's program (``TrackProgram``) against the JAX package's
    host-called ``gauss_newton`` on frame 1, each from its own package's
    frame 0: the pose within 1e-4 m and 1e-4 rad, and ``n_unstable``,
    ``rgb_weight`` and the last group's updates equal; the program's
    preprocessed frame ``torch.equal`` to ``preprocess_packed``'s."""
    frames, make = port
    system = make()
    system.process_frame(frames[0])
    tr = system.tracker
    packed = _pack(frames[1:2])[0]
    prog = tr.program(packed.shape, W)
    prog.load_state(system.state)
    prog.preprocess_and_track(torch.from_numpy(packed))
    jsys = _jax_system(jax_prior)
    jsys.process_frame(next(iter(_sequence(cls=JSequence, intrinsic=JIntrinsic))))
    jtr = jsys.tracker
    init = jtr._gn_init()
    ref = JT.gauss_newton(jtr.tcfg, jtr.map_cfg, jtr.spec, jtr.calib, jtr.dec_params,
                          jsys.state, jtr.last_pose.R, jtr.last_pose.t, jtr.last_pyramid,
                          JT.preprocess_frame_packed(jtr.tcfg, jtr.calib,
                                                     jnp.asarray(packed), H, W),
                          jtr.rgb_weight, jtr.n_unstable, init.R, init.t)
    out = prog.out.double().numpy()
    _assert_poses_close(
        [Isometry.from_matrix(out[:9].reshape(3, 3), out[9:12], ortho=True)],
        [Isometry.from_matrix(np.asarray(ref.final_R, np.float64),
                              np.asarray(ref.final_t, np.float64), ortho=True)])
    assert int(torch.clamp(prog.carry.i - 1, min=0)) == int(ref.last_group_iters)
    assert int(prog.n_unstable) == int(ref.n_unstable)
    assert float(prog.rgb_weight) == float(ref.rgb_weight)
    assert prog.n_unstable.dtype == torch.int32 and prog.rgb_weight.dtype == torch.float32
    cur = T.preprocess_packed(tr.tcfg, tr.calib, torch.from_numpy(packed), W)
    for a, b in zip(T._tensors(prog.cur), T._tensors(cur)):
        assert torch.equal(a, b)


def test_step_past_done_changes_nothing(port):
    """Once ``done``, a further ``gn_step`` returns every carry field
    ``torch.equal`` (what lets a caller run more steps than a group needs)."""
    frames, make = port
    system = make()
    system.process_frame(frames[0])
    tr = system.tracker
    cur = T.preprocess_packed(tr.tcfg, tr.calib, torch.from_numpy(_pack(frames[1:2])[0]), W)
    problem = T.GNProblem(tr.tcfg, tr.map_cfg, tr.packed, tr.cams, system.state,
                          tr.last_pose, cur,
                          T.gn_prepare(tr.tcfg, system.state, tr.last_pyramid, cur),
                          tr.rgb_weight)
    n, terms = ITERS[1]
    carry = T.gn_group_init(Pose.identity("cpu"))
    for _ in range(n + 1):
        carry = T.gn_step(problem, n, terms, carry)
    assert bool(carry.done) and int(carry.i) <= n + 1
    again = T.gn_step(problem, n, terms, carry)
    for a, b in zip(again, carry):
        assert torch.equal(a, b)


def test_chunk_matches_per_frame(per_frame, chunked):
    """``process_chunk`` of K = 5 against 5 ``process_frame`` calls: poses,
    ``state.latents`` and ``obs_count`` ``torch.equal`` (same functions in the
    same order)."""
    for a, b in zip(_poses(chunked), _poses(per_frame)):
        np.testing.assert_array_equal(a, b)
    assert chunked.tracker.n_tracked == N
    assert torch.equal(chunked.state.latents, per_frame.state.latents)
    assert torch.equal(chunked.state.obs_count, per_frame.state.obs_count)
    assert torch.equal(chunked.state.indexer, per_frame.state.indexer)
    assert int(chunked.state.n_occupied) > 100
    assert torch.equal(chunked.tracker.rgb_weight, per_frame.tracker.rgb_weight)
    assert torch.equal(chunked.tracker.last_delta.t, per_frame.tracker.last_delta.t)


def test_split_chunks_match_single_chunk(port, chunked):
    """Chunks of 3 + 2 against one of 5: equal."""
    frames, make = port
    system = make()
    system.process_frame(frames[0])
    packed = torch.from_numpy(_pack(frames[1:]))
    system.process_chunk(packed[:3], W)
    system.process_chunk(packed[3:], W)
    for a, b in zip(_poses(system), _poses(chunked)):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(system.state.latents, chunked.state.latents)
    assert torch.equal(system.state.obs_count, chunked.state.obs_count)


def test_chunk_matches_jax_chunk(chunked, jax_prior):
    """The port's ``process_chunk`` against the JAX package's (one
    ``lax.scan`` of 5 frames, ``warp_tiled=False``): 1e-4 m, 1e-4 rad."""
    jsys = _jax_system(jax_prior)
    frames = list(_sequence(cls=JSequence, intrinsic=JIntrinsic))
    jsys.process_frame(frames[0])
    jsys.process_chunk(jnp.asarray(_pack(frames[1:])), H, W)
    _assert_poses_close(chunked.tracker.all_pd_pose, jsys.tracker.all_pd_pose)
    assert int(chunked.state.n_occupied) == int(jsys.state.n_occupied)


def test_constant_velocity_matches_jax(port, jax_prior):
    """``motion_prior="constant_velocity"`` (each frame's GN starts from the
    last frame's delta) through the port's chunked path against the JAX
    package's per-frame path: 1e-4 m, 1e-4 rad; and the port's own two paths
    agree exactly."""
    frames, make = port
    system = make(motion_prior="constant_velocity")
    system.process_frame(frames[0])
    system.process_chunk(torch.from_numpy(_pack(frames[1:])), W)
    stepwise = make(motion_prior="constant_velocity")
    for frame in frames:
        stepwise.process_frame(frame)
    for a, b in zip(_poses(system), _poses(stepwise)):
        np.testing.assert_array_equal(a, b)
    assert not torch.equal(system.tracker.last_delta.t, torch.zeros(3))
    jsys = _jax_system(jax_prior, motion_prior="constant_velocity")
    for frame in _sequence(cls=JSequence, intrinsic=JIntrinsic):
        jsys.process_frame(frame)
    _assert_poses_close(system.tracker.all_pd_pose, jsys.tracker.all_pd_pose)
    # the JAX result's keys, from its per-frame program compiled just above
    jres = jsys.run_sequence(_sequence(n=2, cls=JSequence, intrinsic=JIntrinsic))
    tres = make().run_sequence(_sequence(n=2))
    assert set(tres) == set(jres)


def test_run_sequence_chunked_matches_per_frame(port):
    """``run_sequence(chunk=3)`` over 8 frames (1 + 3 + 3 + 1) against
    ``run_sequence()``: equal trajectory, voxels and ATE."""
    _, make = port
    a, b = make(), make()
    ra = a.run_sequence(_sequence(n=8), chunk=3)
    rb = b.run_sequence(_sequence(n=8))
    assert ra["n_frames"] == rb["n_frames"] == 8
    for p, q in zip(ra["trajectory"], rb["trajectory"]):
        np.testing.assert_array_equal(p.matrix, q.matrix)
    assert ra["n_voxels"] == rb["n_voxels"] > 100
    assert ra["ate_rmse"] == rb["ate_rmse"] < 5e-3
    assert ra["alloc_overflow"] == 0 and ra["opt_overflow"] == 0
    assert torch.equal(a.state.latents, b.state.latents)
    # profile=True adds the per-stage keys
    c = make()
    c.profile = True
    rc = c.run_sequence(_sequence(n=3))
    assert {"track_ms", "track_first_ms", "integrate_ms", "integrate_first_ms"} <= set(rc)


def test_chunk_refreshes_last_processed(port, chunked):
    """After a chunk ``tracker.last_processed`` is the chunk's final frame
    (as tests/test_scan.py::test_chunk_refreshes_last_processed): a later
    per-frame integrate must fuse it, not a frame from before the chunk."""
    frames, _ = port
    tr = chunked.tracker
    ref = T.preprocess_packed(tr.tcfg, tr.calib, torch.from_numpy(_pack(frames[-1:])[0]), W)
    got = tr.last_processed
    assert torch.equal(got.pts_cam, ref.pts_cam)
    assert torch.equal(got.normals_cam, ref.normals_cam)
    assert torch.equal(got.pc_mask, ref.pc_mask)
    for a, b in zip(T._tensors(tr.last_pyramid), T._tensors(ref.pyramid)):
        assert torch.equal(a, b)
    assert got.pyramid is tr.last_pyramid


def test_gt_pose_mapping_only_matches_jax(port, jax_prior):
    """``use_gt_poses`` (every frame takes its ground-truth pose, no tracking)
    against the JAX package, after every frame: ``n_occupied`` and the indexer
    equal; of the latent entries 98% within rtol 1e-5 (atol 1e-6 near 0), the
    tolerance of one fusion of the same points (tests/test_torch_map.py), and
    none off by more than 1e-3.  The rest is the input, not the fusion: the
    packages' point normals agree to 2e-3 only (closed-form eigenvectors of
    small windows, tests/test_torch_tracker.py), and a world point on a voxel
    face may feed other voxels.  ``chunk`` is ignored in this mode and
    ``process_chunk`` refuses."""
    frames, make = port
    system, jsys = make(), _jax_system(jax_prior)
    system.use_gt_poses = jsys.use_gt_poses = True
    jframes = list(_sequence(n=4, cls=JSequence, intrinsic=JIntrinsic))
    for k in range(4):
        system.process_frame(frames[k])
        jsys.process_frame(jframes[k])
        assert int(system.state.n_occupied) == int(jsys.state.n_occupied) > 100
        np.testing.assert_array_equal(system.state.indexer.numpy(),
                                      np.asarray(jsys.state.indexer))
        got, ref = system.state.latents.numpy(), np.asarray(jsys.state.latents)
        close = np.isclose(got, ref, rtol=1e-5, atol=1e-6)
        assert close.mean() > 0.98 and np.abs(got - ref).max() < 1e-3
    assert system.tracker.n_host_syncs == 0
    for p, f in zip(system.tracker.all_pd_pose, frames):
        np.testing.assert_allclose(p.matrix, f.gt_pose.matrix, atol=1e-6)
    with pytest.raises(RuntimeError):
        system.process_chunk(torch.zeros(1, H, 3 * W, dtype=torch.uint8), W)
    other = make()
    other.use_gt_poses = True
    result = other.run_sequence(_sequence(n=4), chunk=3)
    assert result["ate_rmse"] < 1e-6 and result["n_frames"] == 4
    assert torch.equal(other.state.latents, system.state.latents)


@pytest.mark.parametrize("mode", ["f32", "compensated", "blocked"])
def test_program_driver_matches_host_loop(port, mode):
    """``process_frame`` over 5 tracked frames (fusions on 0, 2, 4; one
    program run a frame, its own world cloud fused) against frame 0 and one
    ``process_chunk`` of 5: poses, latents and the temporal state
    ``torch.equal`` under each ``solve_dtype``; the per-frame program reads
    the map again only after a fusion, and an unknown driver raises."""
    frames, make = port
    stepwise, chunked = make(solve_dtype=mode), make(solve_dtype=mode)
    loads = []
    for frame in frames:
        stepwise.process_frame(frame, driver="program")
        p = next(iter(stepwise.tracker.programs.values()), None)
        loads.append(None if p is None else p._loaded[1])
    chunked.process_frame(frames[0])
    chunked.process_chunk(torch.from_numpy(_pack(frames[1:])), W)
    for a, b in zip(_poses(stepwise), _poses(chunked)):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(stepwise.state.latents, chunked.state.latents)
    assert torch.equal(stepwise.tracker.rgb_weight, chunked.tracker.rgb_weight)
    assert torch.equal(stepwise.tracker.last_delta.t, chunked.tracker.last_delta.t)
    # map tables loaded on frames 1 (after frame 0's fusion), 3 and 5
    assert len({id(t) for t in loads[1:]}) == 3
    with pytest.raises(ValueError):
        stepwise.process_frame(frames[0], driver="graph")


def test_compensated_step_ignores_point_order(port):
    """Under ``compensated`` one GN step (both terms at L0) is ``torch.equal``
    with and without ``perturb_points`` (the same points in another order);
    under f32 the step moves."""
    frames, make = port
    energies = {}
    for mode in ("compensated", "f32"):
        system = make(solve_dtype=mode)
        system.process_frame(frames[0])
        tr = system.tracker
        cur = T.preprocess_packed(tr.tcfg, tr.calib,
                                  torch.from_numpy(_pack(frames[1:2])[0]), W)
        n, terms = ITERS[2]
        steps = []
        for seed in (0, 7):
            inputs = T.gn_prepare(tr.tcfg._replace(perturb_points=seed), system.state,
                                  tr.last_pyramid, cur)
            problem = T.GNProblem(tr.tcfg, tr.map_cfg, tr.packed, tr.cams, system.state,
                                  tr.last_pose, cur, inputs, tr.rgb_weight)
            steps.append(T.gn_step(problem, n, terms, T.gn_group_init(Pose.identity("cpu"))))
        assert not torch.equal(T.gn_prepare(tr.tcfg._replace(perturb_points=7), system.state,
                                            tr.last_pyramid, cur).sdf_pts, cur.pts_cam)
        energies[mode] = steps
    for a, b in zip(*energies["compensated"]):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(*energies["f32"]))


@pytest.mark.parametrize("mode,perturb", [("compensated", 0), ("compensated", 7),
                                          ("blocked", 0)])
def test_gram_modes_chunk_matches_jax(port, jax_prior, monkeypatch, mode, perturb):
    """A chunk of 5 under ``compensated`` / ``blocked`` (and with
    ``perturb_points``) against the JAX package's per-frame path at 1e-4 m,
    1e-4 rad.  The permutation is JAX's own (``jax.random``), handed to the
    port through ``point_permutation``."""
    frames, make = port
    monkeypatch.setattr(T, "point_permutation", lambda seed, n, device: torch.tensor(
        np.asarray(jax.random.permutation(jax.random.key(seed), n))))
    system = make(solve_dtype=mode, perturb_points=perturb)
    system.process_frame(frames[0])
    system.process_chunk(torch.from_numpy(_pack(frames[1:])), W)
    jsys = _jax_system(jax_prior, solve_dtype=mode, perturb_points=perturb)
    for frame in _sequence(cls=JSequence, intrinsic=JIntrinsic):
        jsys.process_frame(frame)
    _assert_poses_close(system.tracker.all_pd_pose, jsys.tracker.all_pd_pose)


@pytest.fixture(scope="module")
def hash_chunked(port):
    """Frame 0 alone, then one chunk of 5, on the hash map with meshing."""
    frames, make = port
    system = make(hash_map=True, meshing=True)
    system.process_frame(frames[0])
    system.process_chunk(torch.from_numpy(_pack(frames[1:])), W)
    return system


def test_hash_chunk_matches_jax_chunk(hash_chunked, jax_prior):
    """The chunk of 5 on the hash map against the JAX package's
    ``process_chunk`` on its hash map: 1e-4 m, 1e-4 rad; the same number of
    voxels, no overflow."""
    jsys = _jax_system(jax_prior, hash_map=True)
    frames = list(_sequence(cls=JSequence, intrinsic=JIntrinsic))
    jsys.process_frame(frames[0])
    jsys.process_chunk(jnp.asarray(_pack(frames[1:])), H, W)
    _assert_poses_close(hash_chunked.tracker.all_pd_pose, jsys.tracker.all_pd_pose)
    assert int(hash_chunked.state.n_occupied) == int(jsys.state.n_occupied) > 100
    assert int(hash_chunked.state.overflow) == int(jsys.state.overflow) == 0


def test_hash_chunk_matches_per_frame(port, hash_chunked):
    """On the hash map the chunked path and the per-frame path (both
    drivers) give ``torch.equal`` poses and latents, and the mesher meshes
    the fused map on both."""
    frames, make = port
    for driver in ("host", "program"):
        system = make(hash_map=True, meshing=True)
        for frame in frames:
            system.process_frame(frame, driver=driver)
        for a, b in zip(_poses(system), _poses(hash_chunked)):
            np.testing.assert_array_equal(a, b)
        assert torch.equal(system.state.latents, hash_chunked.state.latents)
        assert torch.equal(system.state.keys, hash_chunked.state.keys)
        assert len(system.mesher.triangles()[0]) > 100
    assert len(hash_chunked.mesher.triangles()[0]) > 100


def test_unported_options_raise(port):
    """What the chunked path still refuses: ``with_merge`` without a result
    to merge, tracker values outside the JAX package's, and a chunk before
    frame 0.  The tracker's modes run (``gn_unroll=2`` builds with the
    optimizer on)."""
    frames, make = port
    system = make()
    system.process_frame(frames[0])
    packed = torch.from_numpy(_pack(frames[1:2]))
    with pytest.raises(ValueError, match="merge_args"):
        track_fuse_scan(system.tracker, system.encoder, system.state, packed,
                        [False], W, with_merge=True)
    dec, enc, _ = load_prior(HYPER, 300, device="cpu")
    assert SLAMSystem(M.MapConfig(**MAP), T.TrackerConfig(gn_unroll=2), dec, enc,
                      Intrinsic(*CALIB), latent_optimize=True,
                      device="cpu").tracker.tcfg.gn_unroll == 2
    with pytest.raises(NotImplementedError, match="not implemented by the PyTorch port"):
        SLAMSystem(M.MapConfig(**MAP), T.TrackerConfig(gn_unroll=0), dec, enc,
                   Intrinsic(*CALIB), latent_optimize=True, device="cpu")
    with pytest.raises(RuntimeError):
        make().process_chunk(packed, W)          # frame 0 must come first
