"""The port's sequence loaders, native PNG decoder and CLI on the CPU:
ICL-NUIM and ScanNet fixtures written to ``tmp_path`` and read by both
packages' loaders."""
import json
from pathlib import Path

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

cv2 = pytest.importorskip("cv2")

from difusion_tpu.data import native_io as jax_native_io
from difusion_tpu.data import open_sequence as jax_open_sequence
from difusion_tpu.utils.motion import Isometry as JIsometry
from difusion_tpu.utils.motion import Quaternion as JQuaternion
from difusion_tpu_torch import slam
from difusion_tpu_torch.data import native_io
from difusion_tpu_torch.data.production import open_sequence
from difusion_tpu_torch.utils.motion import Isometry, Quaternion

ROOT = Path(__file__).resolve().parents[1]


def _make_icl_dir(path, n=5, seed=0):
    rng = np.random.default_rng(seed)
    (path / "rgb").mkdir()
    (path / "depth").mkdir()
    rows = []
    for i in range(n):
        cv2.imwrite(str(path / "rgb" / f"{i}.png"),
                    rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
        cv2.imwrite(str(path / "depth" / f"{i}.png"),
                    (rng.uniform(0.5, 4.0, (48, 64)) * 5000).astype(np.uint16))
        q = JQuaternion(axis=np.array([0.0, 0.0, 1.0]), degrees=3.0 * i)
        rows.append([i + 1, 0.1 * i, 0.02 * i, 0.05 * i, *q.vector, q.w])
    np.savetxt(path / "groundtruth.txt", np.asarray(rows))
    return path


def _make_scannet_dir(path, n=4):
    rng = np.random.default_rng(1)
    for d in ("color", "depth", "pose", "intrinsic"):
        (path / d).mkdir()
    for i in range(n):
        cv2.imwrite(str(path / "color" / f"{i}.jpg"),
                    rng.integers(0, 255, (60, 80, 3), dtype=np.uint8))
        cv2.imwrite(str(path / "depth" / f"{i}.png"),
                    (rng.uniform(0.5, 4.0, (48, 64)) * 1000).astype(np.uint16))
        np.savetxt(path / "pose" / f"{i}.txt",
                   JIsometry.random(np.random.default_rng(i)).matrix)
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 300.0, 300.0, 32.0, 24.0
    np.savetxt(path / "intrinsic" / "intrinsic_depth.txt", K)
    return path


def _assert_same_sequence(seq, jseq):
    """Frames ``array_equal``; ground truth and ``first_iso`` to 1e-12."""
    assert len(seq) == len(jseq)
    assert tuple(seq.calib) == tuple(jseq.calib)
    for a, b in [(seq.first_iso, jseq.first_iso),
                 *zip(seq.gt_trajectory, jseq.gt_trajectory)]:
        np.testing.assert_allclose(a.q.rotation_matrix, b.q.rotation_matrix, atol=1e-12)
        np.testing.assert_allclose(a.t, b.t, atol=1e-12)
    n = 0
    for f, jf in zip(seq, jseq):
        np.testing.assert_array_equal(f.rgb, jf.rgb)
        np.testing.assert_array_equal(f.depth, jf.depth)
        np.testing.assert_array_equal(f.depth_ok, jf.depth_ok)
        assert f.depth.dtype == np.uint16 and f.frame_id == jf.frame_id
        np.testing.assert_allclose(f.gt_pose.t, jf.gt_pose.t, atol=1e-12)
        n += 1
    assert n == len(jseq)


@pytest.mark.parametrize("kwargs", [
    dict(load_gt=True, first_tq=[-1.4, 1.5, 1.5, 0.0, -1.0, 0.0, 0.0]),
    dict(load_gt=True),
    dict(load_gt=True, start_frame=1, end_frame=4)], ids=["first_tq", "default", "slice"])
def test_icl_loader_matches_jax(tmp_path, kwargs):
    path = _make_icl_dir(tmp_path)
    _assert_same_sequence(
        open_sequence("icl_nuim.ICLNUIMSequence", path=str(path), **kwargs),
        jax_open_sequence("icl_nuim.ICLNUIMSequence", path=str(path), **kwargs))


@pytest.mark.parametrize("frame_skip", [1, 2])
def test_scannet_loader_matches_jax(tmp_path, frame_skip):
    path = _make_scannet_dir(tmp_path)
    seq = open_sequence("scannet.ScanNetSequence", path=str(path), frame_skip=frame_skip)
    assert seq.calib.fx == 300.0 and seq.calib.dcam_scale == 1000.0
    _assert_same_sequence(seq, jax_open_sequence(
        "scannet.ScanNetSequence", path=str(path), frame_skip=frame_skip))


def test_open_sequence_rejects_unknown_type():
    with pytest.raises(ValueError, match="unknown sequence_type"):
        open_sequence("kitti.Sequence")


def test_motion_additions_match_jax():
    """``Quaternion(axis=, degrees=)``, ``Isometry.inv`` and ``.matrix``, which
    the loaders use, to 1e-15."""
    q = Quaternion(axis=[0.3, -0.5, 0.8], degrees=37.0)
    jq = JQuaternion(axis=[0.3, -0.5, 0.8], degrees=37.0)
    np.testing.assert_allclose(q.q, jq.q, atol=1e-15)
    iso, jiso = Isometry(q=q, t=[0.1, -2.0, 3.0]), JIsometry(q=jq, t=[0.1, -2.0, 3.0])
    np.testing.assert_allclose(iso.matrix, jiso.matrix, atol=1e-15)
    np.testing.assert_allclose(iso.inv().matrix, jiso.inv().matrix, atol=1e-15)
    np.testing.assert_allclose(iso.inv().dot(iso).matrix, np.eye(4), atol=1e-15)


def test_native_png_decoder_matches_cv2(tmp_path):
    """The port's own build of native/frameio.cpp decodes 8-bit colour and
    16-bit gray PNGs exactly as cv2 does, and raises on what is no PNG."""
    assert native_io.native_available()
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 255, (37, 53, 3), dtype=np.uint8)
    depth = rng.integers(0, 65535, (37, 53), dtype=np.uint16)
    cv2.imwrite(str(tmp_path / "c.png"), rgb)
    cv2.imwrite(str(tmp_path / "d.png"), depth)
    np.testing.assert_array_equal(native_io.read_png(str(tmp_path / "c.png")),
                                  cv2.cvtColor(rgb, cv2.COLOR_BGR2RGB))
    got = native_io.read_png(str(tmp_path / "d.png"))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, depth)
    (tmp_path / "bad.png").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        native_io.read_png(str(tmp_path / "bad.png"))


@pytest.mark.parametrize("kind", ["rgb", "depth"])
def test_png_prefetcher_matches_read_png_and_jax(tmp_path, kind):
    """PngPrefetcher gives the frames in order, each equal to read_png's and
    to the JAX package's prefetcher's; len is the path count; past the last
    frame it raises; close twice is harmless; PNGs of another size are
    refused before the library sees them."""
    rng = np.random.default_rng(5)
    paths = []
    for i in range(7):
        img = (rng.integers(0, 255, (29, 41, 3), dtype=np.uint8) if kind == "rgb"
               else rng.integers(0, 65535, (29, 41), dtype=np.uint16))
        paths.append(str(tmp_path / f"{kind}_{i}.png"))
        cv2.imwrite(paths[-1], img)
    ours = native_io.PngPrefetcher(paths, ring_size=3, n_threads=2)
    ref = jax_native_io.PngPrefetcher(paths, ring_size=3, n_threads=2)
    assert len(ours) == len(ref) == 7
    for p in paths:
        got = ours.next()
        np.testing.assert_array_equal(got, native_io.read_png(p))
        np.testing.assert_array_equal(got, ref.next())
        assert got.dtype == (np.uint8 if kind == "rgb" else np.uint16)
    with pytest.raises(ValueError):
        ours.next()
    ours.close()
    ours.close()
    ref.close()
    cv2.imwrite(str(tmp_path / "small.png"), np.zeros((3, 4), np.uint8))
    with pytest.raises(ValueError, match="differ"):
        native_io.PngPrefetcher(paths + [str(tmp_path / "small.png")])


def _cli(tmp_path, *extra):
    return [str(ROOT / "configs/fusion-synthetic.yaml"),
            "--set", f"training_hypers={ROOT / 'di-checkpoints/study_mixed/hyper.json'}",
            "--set", "sequence_kwargs.h=120", "--set", "sequence_kwargs.w=160",
            "--output", str(tmp_path / "out"), *extra]


def test_cli_writes_trajectory_and_map(tmp_path, capsys):
    """``main`` on the synthetic config (cut to 120x160, 4 frames, chunks of
    2, the CPU): prints the summary, writes ``trajectory.txt`` (TUM format),
    which parses back to the tracker's poses to 1e-12, and ``map.npz``."""
    result = slam.main(_cli(tmp_path, "--device", "cpu", "--max-frames", "4",
                            "--no-mesh", "--chunk", "2"))
    summary = json.loads(capsys.readouterr().out)
    assert summary["n_frames"] == 4 and "trajectory" not in summary
    assert (tmp_path / "out" / "map.npz").exists()
    assert not (tmp_path / "out" / "mesh.ply").exists()
    rows = np.loadtxt(tmp_path / "out" / "trajectory.txt")
    assert rows.shape == (4, 8)
    for row, pose in zip(rows, result["trajectory"]):
        back = Isometry(q=Quaternion(w=row[7], x=row[4], y=row[5], z=row[6]), t=row[1:4])
        np.testing.assert_allclose(back.matrix, pose.matrix, atol=1e-12)


def test_cli_defaults_to_cuda_and_rejects_unported_flags(tmp_path, capsys, monkeypatch):
    """``--interactive`` (with input at its end: free-runs) and ``--xprof``
    run on the CPU and print the summary; ``--xprof`` writes a Chrome trace.
    The CLI defaults to the card, and without one raises.  (``mesh_tool
    --shard``, still unported, raises in tests/test_torch_meshing.py.)"""
    import torch

    def eof(_=""):
        raise EOFError
    monkeypatch.setattr("builtins.input", eof)
    for flag in (["--interactive"], ["--xprof", str(tmp_path / "trace")]):
        result = slam.main(_cli(tmp_path, "--device", "cpu", "--max-frames", "3",
                                "--no-mesh", *flag))
        out = capsys.readouterr().out
        summary = json.loads(out[out.rindex("{\n"):])     # the summary comes last
        assert summary["n_frames"] == 3 == len(result["trajectory"])
        assert summary["ate_rmse"] < 0.02
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            slam.main(_cli(tmp_path, "--max-frames", "2", "--no-mesh"))
