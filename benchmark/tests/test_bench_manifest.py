"""BENCHMARK.json against the driver's rules, and the harness finding a new
configuration, traffic mix and metric by name."""
import json
import re
import shutil
from pathlib import Path

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_names_units_and_keys_follow_the_rules():
    m = run.load_manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert len(json.dumps(m)) <= 64 * 1024
    assert all(_line(w) for w in m["command"]) and len(m["command"]) <= 32
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and (ROOT / p).is_dir()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
    names = {c["name"] for c in m["configs"]}
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in m["workloads"]}
    e2e = {}
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert NAME.match(e["name"]) and UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
        e2e[e["name"]] = set(e.get("workloads", cells))
    assert "setup_s" in e2e
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert NAME.match(p["name"]) and UNIT.match(p["unit"]) and _line(p["layer"])
        assert p["moves"] in e2e and set(p["workloads"]) <= e2e[p["moves"]]
        if p["name"].endswith("_roofline") or "mfu" in p["name"]:
            assert p["unit"] == "%"
    all_names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert len(all_names) == len(set(all_names))
    for cell in cells:
        assert any(cell in ws for n, ws in e2e.items() if n != "setup_s")
        assert any(cell in p["workloads"] for p in m["per_layer"])


def test_every_file_is_found_by_its_name():
    m = run.load_manifest()
    for w in m["workloads"]:
        spec = run.cell_spec(m, w["name"])
        assert spec["traffic"]["entry"] in ("chunk", "frame", "export")
        for p in spec["per_layer"]:
            assert callable(run.load_reader(p["name"]))


def test_a_new_config_traffic_and_metric_need_no_edit(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = run.load_manifest()
    shutil.copy(bench / "configs" / "lrkt-dense.json", bench / "configs" / "new-model.json")
    traffic = json.loads((bench / "traffic" / "track-chunk12.json").read_text())
    traffic["chunk"] = 6
    (bench / "traffic" / "new-mix.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "new_metric.py").write_text("def read(ctx):\n    return 42.0\n")
    m["configs"].append({"name": "new-model", "source": "x", "file": "benchmark/configs/new-model.json",
                         "reduced": [], "why": "y"})
    m["workloads"].append({"name": "new-model.new-mix", "config": "new-model",
                           "traffic": "new-mix", "chips": 1, "why": "z"})
    m["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "l", "moves": "frame_ms",
                           "workloads": ["new-model.new-mix"]})
    for e in m["end_to_end"]:
        if e["name"] == "frame_ms":
            e["workloads"].append("new-model.new-mix")
    spec = run.cell_spec(m, "new-model.new-mix", bench=bench)
    assert spec["traffic"]["chunk"] == 6
    assert "new_metric" in [p["name"] for p in spec["per_layer"]]
    assert run.load_reader("new_metric", bench=bench)(None) == 42.0
