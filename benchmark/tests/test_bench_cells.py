"""Each cell end to end on the CPU at a tiny size: the check passes on the
port as it is, and fails on the control and on the timed path broken
underneath in each way the cell can break."""
import pytest
import torch

from benchmark import control, faults, run
from benchmark.tests import tiny

CELLS = ["lrkt-dense.track-chunk12", "scannet-hash.live-mesh", "lrkt-dense.export-r8"]
SEED = 2 ** 31 + 4321


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(workload, spec=None):
    spec = spec or tiny.spec(workload)
    res = run.run_cell(spec, SEED, 2.0, False, torch.device("cpu"))
    return res


@pytest.mark.parametrize("workload", CELLS)
def test_the_port_passes(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    for m in run.cell_spec(run.load_manifest(), workload)["end_to_end"]:
        assert res["metrics"][m["name"]]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_traced_run_reads_its_metrics(workload):
    spec = tiny.spec(workload)
    res = run.run_cell(spec, SEED + 1, 1.0, True, torch.device("cpu"))
    assert res["correct"], res["checks"]
    assert "breakdown" in res and res["device"]["window_s"] > 0
    # what the CPU can count; the device's shares need the card
    if spec["traffic"]["entry"] != "export":
        assert res["metrics"]["host_ms_per_frame"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS[:2])
def test_the_ports_bf16_mode_reads_far_above_its_f32(workload):
    # at this size the bf16 mode reads ~4e-4, under the limit that the
    # card's readings at the cell's own size set (their control reads
    # 7e-4 and more, PERF.md); here it is held to its distance from f32
    f32 = control.readings(tiny.spec(workload), SEED, 2.0, "", torch.device("cpu"))
    bf16 = control.readings(tiny.spec(workload), SEED, 2.0, "program", torch.device("cpu"))
    assert bf16["checks"]["energy_gap"] > 20 * max(f32["checks"]["energy_gap"], 1e-6)


@pytest.mark.parametrize("workload", CELLS)
def test_the_bf16_reference_in_the_ports_place_fails(workload):
    spec = tiny.spec(workload)
    got = control.readings(spec, SEED, 2.0, "bf16", torch.device("cpu"))["checks"]
    limits = spec["traffic"]["limits"]
    assert got["latent_gap"] > limits["latent_gap"], got
    if "mesh_lonely" in limits:
        assert got["mesh_lonely"] > limits["mesh_lonely"], got


# -- the timed path broken underneath ----------------------------------------

@pytest.mark.parametrize("workload, fault", [
    (w, f) for w in CELLS[:2] for f in sorted(faults.BY_ENTRY[tiny.spec(w)["traffic"]["entry"]])])
def test_a_broken_tracker_fails(workload, fault, monkeypatch):
    faults.BY_ENTRY[tiny.spec(workload)["traffic"]["entry"]][fault](monkeypatch)
    res = _run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.EXPORT))
def test_a_broken_export_fails(fault, monkeypatch):
    faults.EXPORT[fault](monkeypatch)
    res = _run(CELLS[2])
    assert not res["correct"], res["checks"]
