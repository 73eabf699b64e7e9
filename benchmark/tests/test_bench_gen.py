"""The benchmark's renderer against the port's SyntheticSequence.render."""
import numpy as np
import pytest
import torch

from benchmark.gen import render as G
from difusion_tpu_torch.data.production import SyntheticSequence
from difusion_tpu_torch.ops.imgproc import Intrinsic
from difusion_tpu_torch.utils.motion import Isometry

H, W = 24, 32
INTR = (24.06, 24.0, 15.5, 11.5)
CFG = {"frames": {"h": H, "w": W, "intrinsics": list(INTR), "depth_scale": 5000.0,
                  "lap": 40, "center": [0.5, 1.5], "radii": [2.6, 0.9],
                  "corrugation": 0.1}}


def test_renders_what_the_port_renders():
    R, t = G.lap_poses(40, (0.5, 1.5), (2.6, 0.9))
    seq = SyntheticSequence(n_frames=1, h=H, w=W, calib=Intrinsic(*INTR, 5000.0))
    for j in (0, 7, 23):
        rgb, depth = G.render(torch.from_numpy(R[j:j + 1]), torch.from_numpy(t[j:j + 1]),
                              INTR, H, W, 0.1)
        want_rgb, want_depth, _ = seq.render(Isometry.from_matrix(R[j], t[j], ortho=True))
        got = rgb[0].numpy().astype(int)
        assert np.abs(got - want_rgb).max() <= 1
        assert (got != want_rgb).mean() < 0.01
        sensor = G.sensor_depth(depth, 5000.0)[0].numpy().view(np.uint16).astype(int)
        want = np.clip(want_depth * 5000.0, 0, 65535).astype(np.uint16).astype(int)
        assert np.abs(sensor - want).max() <= 1
        assert (sensor != want).mean() < 0.01


def test_the_lap_closes():
    R, t = G.lap_poses(1510, (0.5, 1.5), (2.6, 0.9))
    steps = np.linalg.norm(np.diff(np.concatenate([t, t[:1]]), axis=0), axis=1)
    # the step from the last frame to the first is a step like any other
    assert abs(steps[-1] - steps[-2]) < 1e-4
    assert steps.max() < 0.012                     # about a centimetre a frame
    rot = np.einsum("nij,nik->njk", R[:-1], R[1:])
    closing = R[-1].T @ R[0]
    assert np.abs(closing - rot[-1]).max() < 1e-4


def test_the_seed_fixes_the_frames_and_only_reorders_poses():
    a = G.render_lap(CFG, 2 ** 31 + 12345, torch.device("cpu"))
    b = G.render_lap(CFG, 2 ** 31 + 12345, torch.device("cpu"))
    assert a.start == b.start
    assert torch.equal(a.rgb, b.rgb) and torch.equal(a.depth, b.depth)
    c = G.render_lap(CFG, 8, torch.device("cpu"))
    np.testing.assert_array_equal(a.R, c.R)          # the same poses
    assert a.start != c.start                         # met in another order


def test_a_cell_renders_only_the_frames_it_reads():
    full = G.render_lap(CFG, 2 ** 32 + 77, torch.device("cpu"))
    part = G.render_lap(CFG, 2 ** 32 + 77, torch.device("cpu"), every=20)
    assert len(part) == len(full) == 40 and part.rgb.shape[0] == 2
    for k in (0, 20, 40, 60):
        for a, b in zip(part.frame(k), full.frame(k)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        part.frame(7)
