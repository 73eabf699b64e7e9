"""The port's synthetic sequences and dataset writers against the JAX
package's on the CPU: the three trajectories at 1e-12, rendered frames
equal, and the ICL-NUIM / ScanNet files byte-equal to the tools' (clean and
with the accuracy study's drift-noisy parameters), read back by the port's
loaders to the ground-truth poses."""
import sys
from pathlib import Path

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

from difusion_tpu.data import SyntheticSequence as JSequence
from difusion_tpu_torch.data import synthetic_icl, synthetic_scannet
from difusion_tpu_torch.data.production import (ICLNUIMSequence, ScanNetSequence,
                                                SyntheticSequence)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tools import make_synthetic_icl, make_synthetic_scannet  # noqa: E402

N = 3


@pytest.mark.parametrize("kind", ["drift", "loop", "out_back"])
@pytest.mark.parametrize("scale", [0.5, 1.2])
def test_trajectories_match_jax(kind, scale):
    """Every pose of 300 frames (the loop300 length) at 1e-12."""
    a = SyntheticSequence(n_frames=300, h=8, w=8, motion_scale=scale, trajectory=kind)
    b = JSequence(n_frames=300, h=8, w=8, motion_scale=scale, trajectory=kind)
    for p, q in zip(a.gt_trajectory, b.gt_trajectory):
        np.testing.assert_allclose(p.matrix, q.matrix, rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        SyntheticSequence(n_frames=2, trajectory="spiral")


@pytest.mark.parametrize("kind", ["loop", "out_back"])
def test_rendered_frames_match_jax(kind):
    """Frames of the new trajectories render equal (RGB, u16 depth,
    validity), through ``frame(k)`` as through iteration."""
    kw = dict(n_frames=40, h=48, w=64, motion_scale=1.2, trajectory=kind)
    a, b = SyntheticSequence(**kw), JSequence(**kw)
    for k in (0, 13, 39):
        b.frame_id = k
        fa, fb = a.frame(k), next(b)
        np.testing.assert_array_equal(fa.rgb, fb.rgb)
        np.testing.assert_array_equal(fa.depth, fb.depth)
        np.testing.assert_array_equal(fa.depth_ok, fb.depth_ok)
    assert [f.frame_id for f in a] == list(range(40))


def _same_files(a: Path, b: Path):
    names = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    return names


@pytest.mark.parametrize("kw", [
    dict(motion_scale=0.5),
    # the accuracy study's drift-noisy parameters (tools/accuracy_study.py:278-286)
    dict(motion_scale=1.0, noise_sigma=0.004, dropout=0.02, seed=3),
    dict(motion_scale=1.2, noise_sigma=0.004, dropout=0.02, seed=3, trajectory="loop"),
], ids=["clean", "noisy", "loop-noisy"])
def test_icl_writer_matches_tool(tmp_path, kw):
    """3 frames at 480x640: rgb/, depth/ and groundtruth.txt byte-equal to
    tools/make_synthetic_icl.py's (the same noise draws in the same order),
    with 2 render threads; the port's loader reads the GT poses back."""
    tq = synthetic_icl.main(str(tmp_path / "port"), N, workers=2, **kw)
    jtq = make_synthetic_icl.main(str(tmp_path / "jax"), N, **kw)
    assert np.allclose(tq, jtq, atol=0)
    names = _same_files(tmp_path / "port", tmp_path / "jax")
    assert len(names) == 2 * N + 1
    seq = ICLNUIMSequence(str(tmp_path / "port"), first_tq=[0, 0, 0, 1, 0, 0, 0],
                          load_gt=True)
    ref = SyntheticSequence(n_frames=N, motion_scale=kw["motion_scale"],
                            trajectory=kw.get("trajectory", "drift"))
    for p, q in zip(seq.gt_trajectory, ref.gt_trajectory):
        np.testing.assert_allclose(p.matrix, q.matrix, atol=1e-9)
    frame = next(seq)
    assert frame.depth.dtype == np.uint16 and frame.rgb.shape == (480, 640, 3)


def test_degrade_depth_draws():
    """Noise first, then holes, then u16: the writer's own function, by
    hand; no draw is made for a clean frame."""
    depth = np.full((4, 5), 10000, np.uint16)
    rng = np.random.default_rng(3)
    got = synthetic_icl.degrade_depth(depth, 5000.0, rng, 0.004, 0.5)
    rng = np.random.default_rng(3)
    z = 2.0 + rng.normal(0.0, 0.004, (4, 5)) * 4.0
    z = np.where(rng.random((4, 5)) < 0.5, 0.0, z)
    np.testing.assert_array_equal(got, np.clip(z * 5000 + 0.5, 0, 65535).astype(np.uint16))
    rng = np.random.default_rng(3)
    assert synthetic_icl.degrade_depth(depth, 5000.0, rng) is depth
    assert rng.random() == np.random.default_rng(3).random()


def test_scannet_writer_matches_tool(tmp_path):
    """3 frames: color/*.jpg (q95), depth/*.png, pose/*.txt and the
    intrinsics byte-equal to tools/make_synthetic_scannet.py's; the port's
    loader reads them back to the renderer's poses and calibration."""
    synthetic_scannet.main(str(tmp_path / "port"), N, workers=2)
    make_synthetic_scannet.main(str(tmp_path / "jax"), N)
    names = _same_files(tmp_path / "port", tmp_path / "jax")
    assert len(names) == 3 * N + 1
    seq = ScanNetSequence(str(tmp_path / "port"))
    ref = SyntheticSequence(n_frames=N, motion_scale=0.5, calib=synthetic_scannet.CALIB)
    assert tuple(seq.calib) == tuple(synthetic_scannet.CALIB)
    for p, q in zip(seq.gt_trajectory, ref.gt_trajectory):
        np.testing.assert_allclose(p.matrix, q.matrix, atol=1e-9)
    frame = next(seq)
    np.testing.assert_array_equal(frame.depth, ref.frame(0).depth)
