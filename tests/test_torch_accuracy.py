"""``python -m difusion_tpu_torch.accuracy`` configures its runs as
tools/accuracy_study.py does (CPU): the tracker of every variant, the dense
map, and the reference rows it sets beside its own."""
import sys
from pathlib import Path

import pytest

import conftest  # noqa: F401  (JAX on the CPU)

from difusion_tpu.core.tracker import TrackerConfig as JTrackerConfig
from difusion_tpu_torch import accuracy
from difusion_tpu_torch.core.tracker import TrackerConfig, check_supported

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tools import accuracy_study  # noqa: E402


@pytest.mark.parametrize("variant", ["default", "packed", "parity", "parity_strict",
                                     "speed", "compensated", "blocked",
                                     "perturbed-7", "perturbed_comp-7",
                                     "perturbed_comp-23", "perturbed_blk-7"])
def test_tracking_args_match_the_study(variant):
    """The same TrackerConfig as the study's (the tiled warp wherever the
    study leaves the JAX default), but for the SDF term's route: the port's
    fused kernel computes the function of the JAX package's XLA route."""
    got = TrackerConfig.from_args(accuracy.tracking_args(variant), point_budget=1 << 13)
    ref = JTrackerConfig.from_args(accuracy_study._tracking_args(variant),
                                   point_budget=1 << 13)
    assert got == tuple(ref._replace(sdf_fused="on"))
    check_supported(got)
    with pytest.raises(ValueError):
        accuracy.tracking_args("spiral")


def test_map_and_reference_rows():
    """The dense map is the study's; the reference file gives the mixed
    prior's rows by (sequence, config)."""
    assert tuple(accuracy.dense_map_cfg()) == tuple(accuracy_study._map_cfg())
    rows = accuracy._reference_rows(ROOT / "ACCURACY_r05.json")
    assert rows[("loop300-noisy", "compensated+self-prior-mixed")]["ate_rmse"] == \
        pytest.approx(0.0590, abs=5e-5)
    assert rows[("drift-noisy", "default+self-prior-mixed")]["ate_rmse"] == \
        pytest.approx(0.0278, abs=5e-5)
    assert rows[("scannet300-synth", "default+hash")]["alloc_overflow"] == 0
    assert accuracy._reference_rows(ROOT / "missing.json") == {}


class _Built(Exception):
    """Raised by a recording SLAMSystem: the run stops once it is built."""


def _recorder(calls):
    class Recording:
        def __init__(self, *args, **kw):
            calls.append((args, kw))
            raise _Built
    return Recording


@pytest.mark.parametrize("optimize", [False, True])
def test_mapping_only_arm_matches_the_study(monkeypatch, optimize):
    """The port's ``mapping_only_ab`` arm builds the study's system
    (tools/accuracy_study.py ``run_mapping_only``): the same map (with
    ``encoder_count_th`` 200), tracker, fusion and meshing schedule,
    optimizer settings and sequence.  What the optimizer then computes is
    held against the JAX package in tests/test_torch_optimize_slam.py; the
    arms' mesh errors come from the card (``PERF.md``)."""
    import difusion_tpu.data as jax_data
    import difusion_tpu.slam as jax_slam
    from difusion_tpu_torch.models.weights import load_prior
    ref, got, seqs = [], [], []

    def sequence(cls):
        def make(**kw):
            seqs.append({k: v for k, v in kw.items() if k != "calib"})
            return cls(**kw)
        return make
    monkeypatch.setattr(accuracy_study, "HYPER", str(accuracy.HYPER))
    monkeypatch.setattr(jax_slam, "SLAMSystem", _recorder(ref))
    monkeypatch.setattr(accuracy, "SLAMSystem", _recorder(got))
    monkeypatch.setattr(jax_data, "SyntheticSequence", sequence(jax_data.SyntheticSequence))
    monkeypatch.setattr(accuracy, "SyntheticSequence", sequence(accuracy.SyntheticSequence))
    with pytest.raises(_Built):
        accuracy_study.run_mapping_only(120, optimize)
    with pytest.raises(_Built):
        accuracy.run_mapping_only(120, optimize, load_prior(accuracy.HYPER, 300, device="cpu"),
                                  "cpu")
    (jargs, jkw), (targs, tkw) = ref[0], got[0]
    assert tuple(targs[0]) == tuple(jargs[0])                    # the map
    assert targs[1] == tuple(jargs[1]._replace(sdf_fused="on"))
    assert tuple(targs[4]) == tuple(jargs[5])                    # the sequence's calib
    assert {k: v for k, v in tkw.items() if k != "device"} == jkw
    assert tkw["latent_optimize"] == optimize and tkw["latent_optimize_mode"] == "sync"
    assert seqs[0] == seqs[1] == dict(n_frames=120, h=480, w=640, corrugation=0.1,
                                      motion_scale=0.5)
