"""Tracking under each variant of the accuracy study (tools/accuracy_study.py)
against the JAX package on the CPU, and the exactness of ``gn_unroll`` and
``sdf_gather_cache``.

Both SLAMSystems track the same 3-frame 120x160 synthetic sequence (fusion
at frames 0 and 2, a short GN schedule, the in-repo prior) under one
variant's tracker settings; the port takes the JAX package's
``warp_tiled=True`` default explicitly.  Poses agree within 1e-4 m and
1e-4 rad in f32 (what remains is f32 summation order in the normal
equations, as tests/test_torch_slam.py), 5e-4 under bf16 (where a sum in
another order can round an activation to the neighbouring bf16 value; the
port's ``speed`` runs kernel 1's bf16 mode where the JAX package, whose
``sdf_fused`` defaults to off, runs its XLA bf16 decode).

``gn_unroll=2`` (two masked GN steps a loop pass) and the gather cache
(accepted; the port gathers every step, which the JAX cache's values equal)
change no value: poses ``torch.equal`` to the runs without them, on the
per-frame and on the chunked path (both through ``TrackProgram``, run
eagerly on the CPU), dense and hash map.  Each mode gives the same poses on
both paths, on both maps."""
from pathlib import Path

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

from difusion_tpu.core import map as JM
from difusion_tpu.core import tracker as JT
from difusion_tpu.data import SyntheticSequence as JSequence
from difusion_tpu.ops.imgproc import Intrinsic as JIntrinsic
from difusion_tpu.slam import SLAMSystem as JSLAMSystem
from difusion_tpu.slam import load_prior as jax_load_prior
from difusion_tpu_torch.core import hash_map as HM
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core import tracker as T
from difusion_tpu_torch.core.tracker import pack_frame
from difusion_tpu_torch.data.production import SyntheticSequence
from difusion_tpu_torch.ops.imgproc import Intrinsic
from difusion_tpu_torch.slam import SLAMSystem, load_prior

torch.set_num_threads(2)
HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"
CALIB = (300.0, 300.0, 79.5, 59.5, 5000.0)
SEQ = dict(n_frames=3, h=120, w=160, corrugation=0.1, motion_scale=0.6)
MAP = dict(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
           latent_dim=29, capacity=1 << 14, prune_min_vox_obs=4,
           ignore_count_th=1.0, encoder_count_th=600.0)
ITERS = ((3, (("rgb", 2),)), (3, (("sdf",), ("rgb", 1))),
         (6, (("sdf",), ("rgb", 0))))
PARITY = dict(xi_tol=0.0, energy_rel_tol=0.0, warp_tiled=False)
VARIANTS = {
    "default": ({}, 1e-4),
    "packed": (dict(warp_tiled=False), 1e-4),
    "parity_strict": (dict(PARITY, rgb_bilinear=False, rgb_fullres_K=True), 1e-4),
    "speed": (dict(rgb_stride=(1, 2, 2), sdf_compute_dtype="bfloat16"), 5e-4),
    "off_bf16_cache": (dict(sdf_fused="off", sdf_compute_dtype="bfloat16",
                            sdf_gather_cache=True), 5e-4),
}


@pytest.fixture(scope="module")
def setup():
    dec, enc, spec = jax_load_prior(str(HYPER), 300)
    t_dec, t_enc, _ = load_prior(HYPER, 300, device="cpu")
    jframes = list(JSequence(calib=JIntrinsic(*CALIB), **SEQ))
    frames = list(SyntheticSequence(calib=Intrinsic(*CALIB), **SEQ))
    return (dec, enc, spec), (t_dec, t_enc), jframes, frames


def _port(setup, map_cfg=None, **kw):
    _, (t_dec, t_enc), _, _ = setup
    tcfg = T.TrackerConfig(point_budget=4096, iter_config=ITERS, **kw)
    return SLAMSystem(map_cfg or M.MapConfig(**MAP), tcfg, t_dec, t_enc, Intrinsic(*CALIB),
                      integrate_interval=2, meshing=False, device="cpu")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_tracks_like_jax(setup, variant):
    (dec, enc, spec), _, jframes, frames = setup
    kw, tol = VARIANTS[variant]
    jsys = JSLAMSystem(JM.MapConfig(**MAP),
                       JT.TrackerConfig(point_budget=4096, iter_config=ITERS, **kw),
                       dec, enc, spec, JIntrinsic(*CALIB), integrate_interval=2,
                       meshing=False)
    for frame in jframes:
        jsys.process_frame(frame)
    tsys = _port(setup, **{"warp_tiled": True, **kw})
    for frame in frames:
        tsys.process_frame(frame)
    jposes, tposes = jsys.tracker.all_pd_pose, tsys.tracker.all_pd_pose
    assert len(tposes) == len(jposes) == SEQ["n_frames"]
    for k, (a, b) in enumerate(zip(tposes, jposes)):
        assert np.abs(a.t - b.t).max() < tol, (k, a.t, b.t)
        dR = a.q.rotation_matrix.T @ b.q.rotation_matrix
        angle = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert angle < tol, (k, angle)
    assert np.abs(tposes[-1].t - frames[-1].gt_pose.t).max() < 1e-2


def _poses(system, frames, chunked):
    system.process_frame(frames[0])
    if chunked:
        packed = np.stack([pack_frame(f.rgb, f.depth, CALIB[4]) for f in frames[1:]])
        system.process_chunk(torch.from_numpy(packed), frames[0].depth.shape[1])
    else:
        for frame in frames[1:]:
            system.process_frame(frame)
    return system.tracker.pose_history()


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("base,extra", [
    (dict(), dict(gn_unroll=2)),
    (dict(sdf_fused="off"), dict(sdf_gather_cache=True)),
    (dict(sdf_fused="off", sdf_compute_dtype="bfloat16"),
     dict(sdf_gather_cache=True, gn_unroll=3)),
])
def test_unroll_and_cache_change_nothing(setup, base, extra, chunked):
    """Poses torch.equal with and without ``gn_unroll`` / the gather cache."""
    *_, frames = setup
    ref = _poses(_port(setup, **base), frames, chunked)
    system = _port(setup, **base, **extra)
    assert system.tracker.tcfg.sdf_gather_cache == extra.get("sdf_gather_cache", False)
    got = _poses(system, frames, chunked)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _hash_map():
    return HM.HashMapConfig(voxel_size=0.1, capacity=1 << 13, table_size=1 << 15,
                            prune_min_vox_obs=4, ignore_count_th=1.0)


def test_gather_cache_is_off_on_the_hash_map(setup):
    """As in the JAX package, the cache changes nothing on the hash map: it
    is accepted there and the poses are the uncached ones."""
    *_, frames = setup
    ref = _poses(_port(setup, map_cfg=_hash_map(), sdf_fused="off"), frames, False)
    system = _port(setup, map_cfg=_hash_map(), sdf_fused="off", sdf_gather_cache=True)
    for a, b in zip(_poses(system, frames, False), ref):
        assert torch.equal(a, b)


def test_sdf_fused_auto_resolves_by_device(setup):
    """``sdf_fused="auto"`` is the autograd route on the CPU (the kernel on a
    card); ``"on"`` packs the f32 and, under bf16, the bf16 weights."""
    tr = _port(setup, sdf_fused="auto").tracker
    assert not tr.sdf_fused and tr.packed is None and tr.packed_bf16 is None
    tr = _port(setup, sdf_compute_dtype="bfloat16").tracker
    assert tr.sdf_fused and tr.packed is not None and tr.packed_bf16 is not None
    assert T.resolve_sdf_fused(T.TrackerConfig(sdf_fused="auto"), tr.decoder.spec, "cuda")


# the modes held per frame against chunked: the study's variants, the f32
# texture of the tiled warp, and speed with two GN steps a loop pass
PATH_MODES = {**{v: VARIANTS[v][0] for v in ("default", "parity_strict", "speed",
                                             "off_bf16_cache")},
              "f32_texture": dict(warp_texture_bf16=False),
              "speed_unroll_2": dict(VARIANTS["speed"][0], gn_unroll=2)}


def _per_frame_equals_chunked(setup, variant, map_cfg=None):
    *_, frames = setup
    kw = {"warp_tiled": True, **PATH_MODES[variant]}
    a = _poses(_port(setup, map_cfg, **kw), frames, False)
    b = _poses(_port(setup, map_cfg, **kw), frames, True)
    assert len(a[0]) == len(b[0]) == SEQ["n_frames"]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("variant", list(PATH_MODES))
def test_variant_per_frame_equals_chunked(setup, variant):
    """Each mode runs on both paths with the same values: the per-frame
    path, one program run a frame, and the chunked path give poses
    torch.equal."""
    _per_frame_equals_chunked(setup, variant)


@pytest.mark.parametrize("variant", list(PATH_MODES))
def test_variant_per_frame_equals_chunked_hash(setup, variant):
    """The same on the hash map: its chunked path runs every mode (the tiled
    warp, the bf16 SDF term, the autograd route, ``gn_unroll``) with the
    per-frame path's values."""
    _per_frame_equals_chunked(setup, variant, _hash_map())
