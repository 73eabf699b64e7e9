"""The map visuals and the interactive driver on the CPU, against the JAX
package: ``get_fast_preview_visuals`` / ``get_map_visuals`` on a map the
port fused (dense and hash; block starts and sample positions exact, the
normalized samples to 1e-5: the decoder's f32 sums run in another order),
``write_pointcloud_ply`` byte for byte (the port's own jet table, equal to
matplotlib's), and ``SLAMSystem.run_interactive`` driven by scripted input
and by end of input (tests/test_slam.py's pattern)."""
from pathlib import Path

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax.numpy as jnp

from difusion_tpu.core import hash_map as JHM
from difusion_tpu.core import map as JM
from difusion_tpu.core import visuals as JV
from difusion_tpu.slam import load_prior as jax_load_prior
from difusion_tpu_torch.core import hash_map as HM
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core import tracker as T
from difusion_tpu_torch.core import visuals as V
from difusion_tpu_torch.core.meshing import _JET, jet_rgb
from difusion_tpu_torch.data.production import SyntheticSequence
from difusion_tpu_torch.ops.imgproc import Intrinsic
from difusion_tpu_torch.slam import SLAMSystem, load_prior

torch.set_num_threads(2)
HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"
CALIB = (300.0, 300.0, 79.5, 59.5, 5000.0)
SEQ = dict(h=120, w=160, corrugation=0.1, motion_scale=0.6)
MAP = dict(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
           latent_dim=29, capacity=1 << 14, prune_min_vox_obs=4,
           ignore_count_th=1.0, encoder_count_th=600.0)
HASH = dict(voxel_size=0.1, latent_dim=29, capacity=1 << 13, table_size=1 << 15,
            prune_min_vox_obs=4, ignore_count_th=1.0)
ITERS = ((3, (("rgb", 2),)), (3, (("sdf",), ("rgb", 1))),
         (6, (("sdf",), ("rgb", 0))))


@pytest.fixture(scope="module")
def priors():
    return jax_load_prior(str(HYPER), 300), load_prior(HYPER, 300, device="cpu")


def _system(priors, map_cfg=None, meshing=True):
    _, (t_dec, t_enc, _) = priors
    return SLAMSystem(map_cfg or M.MapConfig(**MAP),
                      T.TrackerConfig(point_budget=4096, iter_config=ITERS),
                      t_dec, t_enc, Intrinsic(*CALIB), integrate_interval=2,
                      meshing=meshing, device="cpu")


@pytest.fixture(scope="module", params=["dense", "hash"])
def fused(request, priors):
    """A map the port fused from 3 frames, and the same state and config as
    the JAX package's types."""
    cfg = M.MapConfig(**MAP) if request.param == "dense" else HM.HashMapConfig(**HASH)
    system = _system(priors, cfg, meshing=False)
    for frame in SyntheticSequence(n_frames=3, calib=Intrinsic(*CALIB), **SEQ):
        system.process_frame(frame)
    jcls = (JM.MapConfig, JM.MapState) if request.param == "dense" else \
        (JHM.HashMapConfig, JHM.HashMapState)
    jcfg = jcls[0](*cfg)
    jstate = jcls[1](*(jnp.asarray(t.numpy()) for t in system.state))
    return cfg, system.state, jcfg, jstate


def test_jet_table_is_matplotlibs():
    """The port's 256-entry jet table (the machine with the card has no
    matplotlib) equals ``matplotlib.cm.jet``, and its quantization is
    matplotlib's on f32 and f64 values."""
    from matplotlib import cm
    np.testing.assert_array_equal(_JET, cm.jet(np.arange(256))[:, :3])
    t = np.random.default_rng(0).uniform(size=4096)
    t[:3] = (0.0, 1.0, 255.5 / 256)
    for x in (t, t.astype(np.float32)):
        np.testing.assert_array_equal(jet_rgb(x), (cm.jet(x)[:, :3] * 255).astype(np.uint8))


def test_preview_visuals_match_jax(fused):
    cfg, state, jcfg, jstate = fused
    got, ref = V.get_fast_preview_visuals(cfg, state), JV.get_fast_preview_visuals(jcfg, jstate)
    assert len(got.block_starts) > 50
    np.testing.assert_array_equal(got.block_starts, ref.block_starts)
    assert got.block_size == ref.block_size
    for a, b in ((got.bound_min, ref.bound_min), (got.bound_max, ref.bound_max)):
        assert (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.parametrize("sample_range", [None, [-0.1, 0.1]])
def test_map_visuals_and_ply_match_jax(fused, priors, tmp_path, sample_range):
    cfg, state, jcfg, jstate = fused
    (dec, _, spec), (t_dec, _, _) = priors
    got = V.get_map_visuals(cfg, t_dec, state, voxel_resolution=4, sample_range=sample_range)
    ref = JV.get_map_visuals(jcfg, dec, spec, jstate, voxel_resolution=4,
                             sample_range=sample_range)
    np.testing.assert_array_equal(got.block_starts, ref.block_starts)
    np.testing.assert_array_equal(got.sample_xyz, ref.sample_xyz)
    assert len(got.sample_xyz) == 64 * len(got.block_starts)
    np.testing.assert_allclose(got.sample_sdf, ref.sample_sdf, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sample_std, ref.sample_std, atol=1e-5, rtol=0)
    # the writers on the same samples: byte for byte
    V.write_pointcloud_ply(str(tmp_path / "port.ply"), ref.sample_xyz, ref.sample_sdf)
    JV.write_pointcloud_ply(str(tmp_path / "jax.ply"), ref.sample_xyz, ref.sample_sdf)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()


def test_map_visuals_of_an_empty_map(priors):
    _, (t_dec, _, _) = priors
    cfg = M.MapConfig(**MAP)
    vis = V.get_map_visuals(cfg, t_dec, M.create_map_state(cfg, "cpu"))
    assert vis.sample_xyz is None and len(vis.block_starts) == 0


def test_interactive_driver_scripted_stdin(priors, tmp_path, monkeypatch):
    """The terminal loop driven by a scripted command sequence: info, step,
    mesh, render, free-run, an unknown command (steps), quit."""
    seq = SyntheticSequence(n_frames=8, calib=Intrinsic(*CALIB), **SEQ)
    system = _system(priors)
    cmds = iter(["i", "s", "", "m", "v", "i", "r 3", "bogus", "q"])
    monkeypatch.setattr("builtins.input", lambda _="": next(cmds))
    result = system.run_interactive(seq, out_dir=str(tmp_path))
    assert result["n_frames"] == 6
    assert result["n_voxels"] > 50
    assert result["ate_rmse"] < 0.02, result
    pngs = list(tmp_path.glob("view_*.png"))
    assert len(pngs) == 1 and pngs[0].stat().st_size > 1000
    assert len(system.mesher.triangles()[0]) > 100


def test_interactive_driver_eof_free_runs(priors, monkeypatch, capsys):
    """End of input free-runs to the end; without matplotlib ``v`` says it
    cannot render and the loop goes on."""
    seq = SyntheticSequence(n_frames=4, calib=Intrinsic(*CALIB), **SEQ)
    system = _system(priors)
    cmds = iter(["v"])

    def read(_=""):
        return next(cmds)             # StopIteration -> EOFError below

    def scripted(prompt=""):
        try:
            return read(prompt)
        except StopIteration:
            raise EOFError from None
    monkeypatch.setattr("builtins.input", scripted)
    import builtins
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *args, **kw)
    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    result = system.run_interactive(seq)
    assert result["n_frames"] == 4 and result["ate_rmse"] < 0.02, result
    assert "cannot render" in capsys.readouterr().out
