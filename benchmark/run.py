"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (render the lap from the seed, load the
prior, build the system, warm up the cell's shapes) is timed as ``setup_s``
from the start of this process; then the window runs for ``--seconds``.
With ``--trace 1`` a second window of the traffic's ``trace_seconds``
follows under the profiler: the per-layer metrics read on the host clock
(spans, latencies) come from the first window, which the profiler does not
slow, and those of the device from the second.  Then the peak memory is
read, the port's state is freed, and the plain reference judges what the
windows produced (:mod:`.check`).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and ``breakdown`` when tracing), then ``checks``:
each number compared with its limit, which also end standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "difusion_tpu")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_spec(manifest: dict, workload: str, bench: Path = BENCH) -> dict:
    """Everything one cell needs, found by the names in the manifest:
    ``configs/<config>.json``, ``traffic/<traffic>.json`` and the readers
    ``metrics/<metric>.py`` of the per-layer metrics it reports."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    cfg = json.loads((bench / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if m["moves"] in e2e_names and workload in m.get("workloads", [workload])]
    return {"cell": cell, "cfg": cfg, "traffic": traffic, "end_to_end": e2e,
            "per_layer": per_layer}


def load_reader(name: str, bench: Path = BENCH):
    """The per-layer metric's reader: ``metrics/<name>.py``'s ``read``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's, Flax's
    or the JAX package's, compared whole (``difusion_tpu_torch`` is not
    ``difusion_tpu``)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the port
    keeps its nvcc libraries under ``build/difusion_tpu_torch`` itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "bench_cache" / sub)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, drivers=None) -> dict:
    """Set-up, window, check.  ``device``: a torch device; ``drivers``
    replaces :data:`.drive.DRIVERS` (the tests break the timed path through
    it)."""
    import torch

    from . import check, drive
    from .trace import Context, traced
    drivers = drivers or drive.DRIVERS
    cfg, traffic = spec["cfg"], spec["traffic"]
    spans = drive.Spans()
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    driver = drivers[traffic["entry"]](cfg, traffic, seed, device, spans)
    setup_s = time.perf_counter() - t_start
    metrics = {}
    extra = {}
    breakdown = None
    n_setup = len(spans.items)
    out = driver.window(seconds)
    print(f"window: {out}", file=sys.stderr, flush=True)
    if not trace:
        for m in spec["end_to_end"]:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            else:
                metrics[m["name"]] = {"value": out[m["name"]], "unit": m["unit"]}
    else:
        host = (spans.items[n_setup:], out, driver.window_frames)
        before = driver.counters()
        n_host = len(spans.items)
        traced_out, tr = traced(driver, float(traffic["trace_seconds"]))
        after = driver.counters()
        window_spans = spans.items[n_host:]
        ctx = Context(driver, window_spans, traced_out, tr,
                      {k: after[k] - before[k] for k in after}, host)
        for m in spec["per_layer"]:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s(),
                 "graph_launches": tr.n_graph_launches,
                 "graph_launches_seen": tr.n_graph_launches_seen}
        breakdown = tr.breakdown(window_spans)
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": int(spec["cell"]["chips"]),
                "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                      if device.type == "cuda" else 0)}
    dev_info.update(extra)
    served = driver.served()
    attempted = len(driver.attempted)
    driver.free()
    del driver
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check.judge(cfg, traffic, seed, served, device)
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(ok), "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if served.get("readings"):
        result["readings"] = served["readings"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = cell_spec(load_manifest(), args.workload)
    _cache_dirs(ROOT)
    import torch
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import difusion_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the port is not in this checkout: {e}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 4
    result["device"]["card"] = _power_limit()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
