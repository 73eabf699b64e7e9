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


@pytest.mark.parametrize("variant", ["default", "compensated", "blocked",
                                     "perturbed-7", "perturbed_comp-7",
                                     "perturbed_comp-23", "perturbed_blk-7"])
def test_tracking_args_match_the_study(variant):
    """The same TrackerConfig as the study's, but for the two routes the
    port takes alone (the per-pixel warp, the fused SDF kernel)."""
    got = TrackerConfig.from_args(accuracy.tracking_args(variant), point_budget=1 << 13)
    ref = JTrackerConfig.from_args(accuracy_study._tracking_args(variant),
                                   point_budget=1 << 13)
    assert got == tuple(ref._replace(warp_tiled=False, sdf_fused="on"))
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
