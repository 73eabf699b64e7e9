"""``SLAMSystem(latent_optimize=True)`` on the CPU at 120x160 with the
in-repo prior: against the JAX package under ground-truth poses (sync and
interleaved, dense and hash map), the chunked path against the per-frame
path (``track_fuse_scan(with_merge=True)``), the pending result's snapshot
against later fusions and extracts, and ``from_config``'s keys.  The port's
samples take the JAX package's draws (``jax.random.key(7)``, split once a
call) where the two are compared."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax

from difusion_tpu.core import hash_map as JHM
from difusion_tpu.core import map as JM
from difusion_tpu.core import tracker as JT
from difusion_tpu.data import SyntheticSequence as JSequence
from difusion_tpu.ops.imgproc import Intrinsic as JIntrinsic
from difusion_tpu.slam import SLAMSystem as JSLAMSystem
from difusion_tpu.slam import load_prior as jax_load_prior
from difusion_tpu_torch import slam as slam_mod
from difusion_tpu_torch.config import dict_to_args
from difusion_tpu_torch.core import hash_map as HM
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core import tracker as T
from difusion_tpu_torch.ops.imgproc import Intrinsic
from difusion_tpu_torch.slam import SLAMSystem, load_prior
from test_torch_scan import CALIB, HASH, HYPER, ITERS, MAP, W, _pack, _sequence

# voxels converge after one fusion, so the optimizer has work from frame 0
OPT_MAP = dict(MAP, encoder_count_th=20.0)
OPT_HASH = dict(HASH, encoder_count_th=20.0)
OPT = dict(latent_optimize=True, optim_n_iters=5)
# where the two paths of the port are compared: a shorter schedule and budget
LIGHT = dict(point_budget=2048, iter_config=((2, (("rgb", 2),)), (2, (("sdf",), ("rgb", 1))),
                                             (3, (("sdf",), ("rgb", 0)))))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several workers at once: two threads each keep
    them from crowding the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    dec, enc, _ = load_prior(HYPER, 300, device="cpu")

    def make(hash_map=False, integrate_interval=2, meshing=False, tracker=None, **kw):
        return SLAMSystem(HM.HashMapConfig(**OPT_HASH) if hash_map else M.MapConfig(**OPT_MAP),
                          T.TrackerConfig(**(tracker or dict(point_budget=4096,
                                                             iter_config=ITERS))),
                          dec, enc, Intrinsic(*CALIB), integrate_interval=integrate_interval,
                          meshing=meshing, device="cpu", **kw)
    return list(_sequence(n=7)), make


def _jax_draws(system):
    """Make the port system draw its samples' noise as the JAX system does."""
    key = [jax.random.key(7)]

    def draw(n):
        key[0], sub = jax.random.split(key[0])
        return torch.from_numpy(np.array(jax.random.normal(sub, (n, 8))))
    system._draw_noise = draw


@pytest.mark.parametrize("mode,hash_map", [("sync", False), ("interleaved", False),
                                           ("interleaved", True)])
def test_gt_pose_optimizer_matches_jax(port, mode, hash_map):
    """Mapping-only (``use_gt_poses``), fusion every 2 frames, 5 Adam
    iterations a fusion, after every frame: ``n_occupied``, the slot table
    and ``optimized`` equal; the latents at the mapping-only test's
    tolerance (tests/test_torch_scan.py: 98% within rtol 1e-5, atol 1e-6,
    and none of the voxels the optimizer left alone off by more than
    1e-3).  The optimized voxels' entries: 98% within 1e-3, none beyond
    3 lr (0.03).  Not tighter there: the inputs differ (point normals agree
    to 2e-3 only, tests/test_torch_tracker.py), and Adam's first step moves
    an entry by about +-lr whatever its gradient's size, so where the
    summed gradient is near 0 the two packages can step opposite ways."""
    frames, make = port
    dec, enc, spec = jax_load_prior(str(HYPER), 300)
    system = make(hash_map=hash_map, latent_optimize_mode=mode, **OPT)
    jsys = JSLAMSystem(JHM.HashMapConfig(**OPT_HASH) if hash_map else JM.MapConfig(**OPT_MAP),
                       JT.TrackerConfig(point_budget=4096, warp_tiled=False,
                                        iter_config=ITERS),
                       dec, enc, spec, JIntrinsic(*CALIB), integrate_interval=2,
                       meshing=False, latent_optimize_mode=mode, **OPT)
    _jax_draws(system)
    system.use_gt_poses = jsys.use_gt_poses = True
    jframes = list(_sequence(n=5, cls=JSequence, intrinsic=JIntrinsic))
    for k in range(5):
        system.process_frame(frames[k])
        jsys.process_frame(jframes[k])
        assert int(system.state.n_occupied) == int(jsys.state.n_occupied) > 100
        table = "slot_cell" if hash_map else "indexer"
        np.testing.assert_array_equal(getattr(system.state, table).numpy(),
                                      np.asarray(getattr(jsys.state, table)))
        opt = system.state.optimized.numpy()
        np.testing.assert_array_equal(opt, np.asarray(jsys.state.optimized))
        got, ref = system.state.latents.numpy(), np.asarray(jsys.state.latents)
        close = np.isclose(got, ref, rtol=1e-5, atol=1e-6)
        assert close.mean() > 0.98 and np.abs(got - ref)[~opt].max() < 1e-3
        err = np.abs(got - ref)[opt]
        if opt.any():
            assert (err <= 1e-3).mean() > 0.98 and err.max() < 0.03
    assert int(system.state.optimized.sum()) > 200
    assert int(system.state.opt_overflow) == int(jsys.state.opt_overflow) == 0
    assert (system._pending_opt is None) == (jsys._pending_opt is None) == (mode == "sync")


def _poses(system):
    return [t.numpy() for t in system.tracker.pose_history()]


@pytest.mark.parametrize("mode,hash_map,meshing", [("interleaved", False, True),
                                                   ("sync", False, False),
                                                   ("interleaved", True, False)])
def test_chunked_optimizer_equals_per_frame(port, mode, hash_map, meshing):
    """Fusion every 3 frames: 7 frames per frame against frame 0 and two
    chunks of 3 (one fusion each, the pending result merged inside the
    chunk at its fusion frame, ``with_merge``): poses, latents, the flags
    and the pending result ``torch.equal``, and the same noise drawn
    (tests/test_scan.py asserts this for the JAX package)."""
    frames, make = port
    ref = make(hash_map=hash_map, integrate_interval=3, meshing=meshing, tracker=LIGHT,
               latent_optimize_mode=mode, **OPT)
    for frame in frames:
        ref.process_frame(frame)
    chunked = make(hash_map=hash_map, integrate_interval=3, meshing=meshing, tracker=LIGHT,
                   latent_optimize_mode=mode, **OPT)
    merges = []
    chunked.process_frame(frames[0])
    inner = slam_mod.apply_merge
    try:
        slam_mod.apply_merge = lambda s, a: merges.append(len(merges)) or inner(s, a)
        chunked.process_chunk(torch.from_numpy(_pack(frames[1:4])), W)
        chunked.process_chunk(torch.from_numpy(_pack(frames[4:7])), W)
    finally:
        slam_mod.apply_merge = inner
    assert len(merges) == (2 if mode == "interleaved" else 0)
    for a, b in zip(_poses(chunked), _poses(ref)):
        np.testing.assert_array_equal(a, b)
    for f in ("latents", "obs_count", "optimized", "mesh_dirty", "opt_overflow"):
        assert torch.equal(getattr(chunked.state, f), getattr(ref.state, f)), f
    assert int(ref.state.optimized.sum()) > 100
    assert (chunked._pending_opt is None) == (ref._pending_opt is None) == (mode == "sync")
    if mode == "interleaved":
        for a, b in zip(T._tensors(chunked._pending_opt[:3]), T._tensors(ref._pending_opt[:3])):
            assert torch.equal(a, b)
        assert torch.equal(chunked._pending_opt[3].latents, ref._pending_opt[3].latents)
    assert torch.equal(torch.randn(4, generator=chunked._opt_gen),
                       torch.randn(4, generator=ref._opt_gen))
    if meshing:
        np.testing.assert_array_equal(chunked.mesher.triangles()[0], ref.mesher.triangles()[0])


def test_pending_snapshot_survives_fusion_and_extract(port):
    """Interleaved, meshing on every fusion: the pending result's snapshot
    (old latents, counts and flags, the optimized state) holds the values
    it had when it was taken through that frame's extract, the frames up to
    the next fusion, and until the merge reads it there; the tensors it held
    still hold them after that fusion."""
    frames, make = port
    system = make(meshing=True, tracker=LIGHT, latent_optimize_mode="interleaved", **OPT)
    system.process_frame(frames[0])
    system.process_frame(frames[1])
    system.process_frame(frames[2])                  # fusion, optimize, extract
    assert system._pending_opt is not None
    held = T._tensors(system._pending_opt[:3]) + list(system._pending_opt[3])
    copies = [t.clone() for t in held]
    seen = []
    inner = slam_mod.apply_merge

    def checking_merge(state, args):
        seen.append(all(torch.equal(a, b) for a, b in zip(held, copies)))
        return inner(state, args)
    system.process_frame(frames[3])
    try:
        slam_mod.apply_merge = checking_merge
        system.process_frame(frames[4])              # merge, fusion, optimize, extract
    finally:
        slam_mod.apply_merge = inner
    assert seen == [True]
    assert all(torch.equal(a, b) for a, b in zip(held, copies))
    assert int(system.state.optimized.sum()) > 100


def test_from_config_optimizer_keys_and_run_sequence(port):
    """``from_config`` reads ``latent_optimize``, ``optim_n_iters`` and
    ``code_regularization`` / ``code_reg_lambda`` under ``mapping`` and
    ``mesh_fast`` / ``run_async`` at the top level; ``run_sequence`` under
    ground-truth poses optimizes and reports the state's ``opt_overflow``."""
    mapping = {"bound_min": [-2.0, -2.0, -0.5], "bound_max": [2.0, 2.0, 3.5],
               "voxel_size": 0.1, "prune_min_vox_obs": 4, "ignore_count_th": 1.0,
               "encoder_count_th": 20.0, "latent_optimize": True, "optim_n_iters": 3,
               "code_regularization": True, "code_reg_lambda": 0.01}
    args = dict_to_args({
        "training_hypers": str(HYPER), "using_epoch": 300, "integrate_interval": 2,
        "mesh_fast": True, "run_async": True, "mapping": mapping,
        "tracking": {"iter_config": [{"n": 3, "type": [["rgb", 2]]}],
                     "sdf": {"robust_kernel": "huber", "robust_k": 5.0, "subsample": 0.5},
                     "rgb": {"weight": 500.0, "robust_kernel": None, "robust_k": 0.01,
                             "min_grad_scale": 0.0, "max_depth_delta": 0.2}}})
    system = SLAMSystem.from_config(args, Intrinsic(*CALIB), None, capacity=1 << 14,
                                    point_budget=2048, device="cpu")
    assert system.latent_optimize and system.optim_n_iters == 3
    assert system.code_reg_lambda == 0.01 and system.latent_optimize_mode == "interleaved"
    assert system.mesher.fast and system._mesh_executor is not None
    mapping["code_regularization"] = False
    assert SLAMSystem.from_config(args, Intrinsic(*CALIB), None, capacity=1 << 14,
                                  point_budget=4096, device="cpu").code_reg_lambda == 0.0
    system.use_gt_poses = True
    system.state = system.state._replace(opt_overflow=torch.tensor(5, dtype=torch.int32))
    result = system.run_sequence(_sequence(n=4), chunk=3)
    assert result["opt_overflow"] == 5 and result["n_frames"] == 4
    assert int(system.state.optimized.sum()) > 0
    assert len(system.mesher.triangles()[0]) > 100
