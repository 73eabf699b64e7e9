"""The port against the JAX package on the accuracy study's loop300-noisy
sequence under ``solve_dtype: compensated`` (CPU).

Run as a script, this file also writes the JAX package's own CPU rows of
the loop and ScanNet sequences with the in-repo prior, through
``tools/accuracy_study.py``'s ``main`` as it stands (the study reads the
ScanNet run's prior and data directory from module constants, which the
script points at the in-repo prior and at ``OUT``):

    JAX_PLATFORMS=cpu python tests/test_torch_accuracy_loop.py OUT [--scannet 300]

``OUT/results.json`` then holds loop300-clean and loop300-noisy under
``compensated`` and, with ``--scannet``, scannet300-synth.  The port's rows
of the same sequences: ``python -m difusion_tpu_torch.accuracy --device cpu
--only loop300 --perturb-variants "" --mapping-only 0 --out OUT`` (and
``--only scannet --scannet 300``); run it first with the same ``OUT`` and
the JAX study reads the datasets the port's writers wrote (byte-equal to
the study's own, ``tests/test_torch_synthetic.py``).
"""
from __future__ import annotations

import itertools
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HYPER = ROOT / "di-checkpoints/study_mixed/hyper.json"
# loop300-noisy as the study writes it (tools/accuracy_study.py main)
LOOP_NOISY = dict(n_frames=300, motion_scale=1.2, trajectory="loop", noise_sigma=0.004,
                  dropout=0.02, seed=3)
FIRST = 3           # frames of it tracked here: frame 0 (fused), then two
# m and rad, port against the JAX package: the f32 tolerance of
# tests/test_torch_tracker_variants.py (measured on the CPU: 4.6e-5 m and
# 2.8e-5 rad at most over the first five frames)
POSE_TOL = 1e-4


def test_loop300_noisy_first_frames_track_like_jax(tmp_path, monkeypatch):
    """The first FIRST frames of loop300-noisy, written by the port's writer
    (byte-equal to the study's) and read back by each package's ICL-NUIM
    loader, tracked under ``compensated`` by the study's system (its dense
    map, tracker, point budget and fusion cadence; meshing off) in both
    packages: every pose within POSE_TOL m and rad.  ``compensated`` sums
    the normal equations by TwoSum in an order-independent way, so what
    remains is f32 rounding inside the terms and in the map fused from frame
    0 (the JAX package's stencil moments are FMA-contracted by XLA on the
    CPU: tests/test_torch_tracker.py); the study's 300-frame rows of the two
    packages on the CPU are compared in PERF.md."""
    import torch

    import conftest  # noqa: F401  (JAX on the CPU)
    from difusion_tpu.core.tracker import TrackerConfig as JTrackerConfig
    from difusion_tpu.data.production import ICLNUIMSequence as JICL
    from difusion_tpu.slam import SLAMSystem as JSLAMSystem
    from difusion_tpu.slam import load_prior as jax_load_prior
    from difusion_tpu_torch import accuracy
    from difusion_tpu_torch.core.tracker import TrackerConfig
    from difusion_tpu_torch.data import synthetic_icl
    from difusion_tpu_torch.data.production import ICLNUIMSequence
    from difusion_tpu_torch.slam import SLAMSystem, load_prior
    sys.path.insert(0, str(ROOT))
    from tools import accuracy_study as study

    torch.set_num_threads(2)
    render = synthetic_icl.rendered_frames
    monkeypatch.setattr(synthetic_icl, "rendered_frames",
                        lambda seq, workers: itertools.islice(render(seq, 1), FIRST))
    synthetic_icl.main(str(tmp_path), **LOOP_NOISY)
    first_tq = [0, 0, 0, 1, 0, 0, 0]

    seq = ICLNUIMSequence(path=str(tmp_path), first_tq=first_tq, load_gt=True)
    dec, enc, _ = load_prior(HYPER, 300, device="cpu")
    port = SLAMSystem(accuracy.dense_map_cfg(),
                      TrackerConfig.from_args(accuracy.tracking_args("compensated"),
                                              point_budget=1 << 13),
                      dec, enc, seq.calib, integrate_interval=20, depth_cut=(0.5, 5.0),
                      meshing=False, device="cpu")
    got = port.run_sequence(seq, max_frames=FIRST, chunk=12)["trajectory"]

    jseq = JICL(path=str(tmp_path), first_tq=first_tq, load_gt=True)
    jdec, jenc, spec = jax_load_prior(str(HYPER), 300)
    ref_sys = JSLAMSystem(study._map_cfg(),
                          JTrackerConfig.from_args(study._tracking_args("compensated"),
                                                   point_budget=1 << 13),
                          jdec, jenc, spec, jseq.calib, integrate_interval=20,
                          depth_cut=(0.5, 5.0), meshing=False)
    ref = ref_sys.run_sequence(jseq, max_frames=FIRST)["trajectory"]

    assert len(got) == len(ref) == FIRST
    for k, (a, b) in enumerate(zip(got, ref)):
        assert np.abs(a.t - b.t).max() < POSE_TOL, (k, a.t, b.t)
        dR = a.q.rotation_matrix.T @ b.q.rotation_matrix
        angle = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert angle < POSE_TOL, (k, angle)
    # the frames moved: a pose off the first one
    assert np.abs(got[-1].t).max() > 1e-3


def jax_study_rows(out: str, scannet: int = 0) -> None:
    """tools/accuracy_study.py's loop300 rows under compensated (and its
    ScanNet row) on the in-repo prior, written under ``out``."""
    sys.path.insert(0, str(ROOT))
    from tools import accuracy_study as study
    study.HYPER = str(HYPER)
    path = study.Path

    def redirected(*parts):
        if parts and str(parts[0]) == "/tmp/acc_study":
            return path(out, *parts[1:])
        return path(*parts)
    study.Path = redirected
    study.main(["--only", "loop300", "--variants", "compensated", "--hyper", str(HYPER),
                "--out", out, "--scannet", str(scannet)])


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out")
    parser.add_argument("--scannet", type=int, default=0)
    cli = parser.parse_args()
    jax_study_rows(cli.out, cli.scannet)
