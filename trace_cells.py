"""Run one cell of ``BENCHMARK.json`` with the port's span recorder on, and
print what the port's spans and the tracker's device stamps read.

    python3 trace_cells.py --workload <cell> --seed <n> --seconds <s> [--trace 0|1]

From the root of a checkout, on the card.  The cell runs as ``python3 -m
benchmark.run`` runs it (set-up, the window, with ``--trace 1`` the window
under the profiler, the check), with :mod:`difusion_tpu_torch.utils.tracing`
switched on before the system is built, so that the tracker's graph program
is captured with its stamps.  The benchmark itself leaves the recorder off.

The last line of standard output is the benchmark's result line and more
keys: ``window`` (the first window's own numbers, taken with the recorder
on), ``launches`` (every kernel's launches by ``_build.launch_counts()``
from the process's start to the first window's end: the wide instances
under ``decode_grad_wide`` and ``decode_fwd_wide``), ``decode_instance``
(the instance the mesher's last decode used, from its ``last_stats``;
None where the cell meshes nothing), ``cond_rows`` (the rows a conditioned
family's (onet_cbn's, pigan_film's) tracker table and mesher conditioned in the first
window: ``CondTable.cond_rows()``, ``MeshExtractor.cond_rows``; None for a
decoder without one), ``spans`` (:func:`readings`; a number the cell has nothing for is
None), ``by_name`` (:func:`by_name`), ``segment_ms`` (the tracker's
segments, ms a frame of the first window) and, with ``--trace 1``,
``clock_offset_ns``: the profiler's clock less the host's, from the
recorder's mark and from the benchmark's own window annotation.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from difusion_tpu_torch.ops import _build

SUM = {"feed_wait_ms_per_frame": ("slam.wait_feed",),
       "feeder_ms_per_frame": ("slam.feed.pack", "slam.feed.stack", "slam.feed.upload"),
       "upload_ms_per_frame": ("slam.frame.pack", "slam.frame.upload")}


class Window:
    """One window of a run: its span on the host clock (ns), its numbers
    and the change of the tracker's segment times over it (ns)."""

    def __init__(self, t0: int, t1: int, out: dict, segments: Dict[str, int],
                 launches: Optional[Dict[str, int]] = None, instance: Optional[str] = None,
                 cond_rows: Optional[int] = None):
        self.t0, self.t1, self.out, self.segments = t0, t1, out, segments
        self.launches, self.instance, self.cond_rows = launches or {}, instance, cond_rows

    def items(self) -> int:
        return int(self.out.get("frames", self.out.get("extracts", 0)))


def _segment_ns(driver) -> Dict[str, int]:
    system = getattr(driver, "system", None)
    progs = list(system.tracker.programs.values()) if system is not None else []
    return progs[0].program.segment_ns() if progs and progs[0].program else {}


def _cond_rows(driver) -> Optional[int]:
    """Rows conditioned so far by the tracker's conditioning table (onet_cbn,
    pigan_film) and the driver's mesher, or None where neither conditions."""
    system = getattr(driver, "system", None)
    table = getattr(getattr(system, "tracker", None), "cond", None)
    mesher = getattr(driver, "mesher", None) or getattr(system, "mesher", None)
    counts = ([table.cond_rows()] if table is not None else []) + \
        ([mesher.cond_rows] if getattr(mesher, "cond_rows", 0) else [])
    return sum(counts) if counts else None


def watched(cls, windows: List[Window]):
    """``cls`` (a benchmark driver) noting each window in ``windows``."""
    class Watched(cls):
        def window(self, seconds):
            before, rows0 = _segment_ns(self), _cond_rows(self)
            t0 = time.perf_counter_ns()
            out = super().window(seconds)
            t1 = time.perf_counter_ns()
            after, rows1 = _segment_ns(self), _cond_rows(self)
            mesher = getattr(self, "mesher", None) or getattr(
                getattr(self, "system", None), "mesher", None)
            windows.append(Window(t0, t1, out, {k: after[k] - before.get(k, 0)
                                                for k in after},
                                  {k: v for k, v in _build.launch_counts().items() if v},
                                  mesher.last_stats.get("decode_instance")
                                  if mesher is not None else None,
                                  rows1 - (rows0 or 0) if rows1 is not None else None))
            return out
    return Watched


def _inside(spans, w: Window) -> List[int]:
    """Indices of the closed spans that start in window ``w``."""
    return [k for k, s in enumerate(spans) if s.end_ns >= 0 and w.t0 <= s.start_ns < w.t1]


def _self_intervals(spans, keep: List[int]) -> List[Tuple[int, int, object]]:
    """Each kept span's interval less its children's: (start, end, span)
    pieces; at any instant the piece that holds it is the innermost span's."""
    kids: Dict[int, list] = {}
    for k in keep:
        kids.setdefault(spans[k].parent, []).append(spans[k])
    pieces = []
    for k in keep:
        s = spans[k]
        a = s.start_ns
        for c in sorted(kids.get(k, []), key=lambda c: c.start_ns):
            if c.start_ns > a:
                pieces.append((a, c.start_ns, s))
            a = max(a, c.end_ns)
        if s.end_ns > a:
            pieces.append((a, s.end_ns, s))
    return pieces


def _overlap(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_work_idle(spans, trace, offset_ns: int, thread: int) -> Optional[float]:
    """Percent of the traced window in which the card was idle while
    ``thread``'s innermost port span was not a device wait: the spans laid
    on the profiler's clock by ``offset_ns``."""
    if trace.window is None:
        return None
    w0, w1 = trace.window
    mine = [k for k, s in enumerate(spans) if s.thread == thread and s.end_ns >= 0]
    work = sorted((a + offset_ns, b + offset_ns) for a, b, s in _self_intervals(spans, mine)
                  if not s.wait)
    busy = trace.busy_intervals()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return 100.0 * _overlap(idle, work) / (w1 - w0) if w1 > w0 else None


def readings(spans, first: Window, trace=None, offset_ns: Optional[int] = None,
             thread: Optional[int] = None) -> Dict[str, Optional[float]]:
    """The per-layer numbers the port's spans give: sums a frame of the
    first (untraced) window, the tracker's GN loops on the device a frame,
    the live extract's median, the export's device waits an extract, and
    (given the traced window's trace and the clocks' offset) the share of
    the traced window the card idled while the host worked; a conditioned
    decoder's conditioning: the table's refreshes (``map.cond``) a frame
    and the export's ``mesh.cond`` an extract."""
    win = [spans[k] for k in _inside(spans, first)]
    n = first.items()
    out: Dict[str, Optional[float]] = {}
    for name, names in SUM.items():
        got = [s for s in win if s.name in names]
        out[name] = 1e3 * sum(s.seconds for s in got) / n if got and n else None
    gn = [v for k, v in first.segments.items() if k.endswith(".gn")]
    out["gn_device_ms_per_frame"] = 1e-6 * sum(gn) / n if gn and n else None
    live = [s.seconds for s in win if s.name == "slam.mesh"]
    out["live_extract_ms"] = 1e3 * statistics.median(live) if live else None
    # the offline extracts: mesh.extract spans that no port span holds
    extracts = {k for k in _inside(spans, first)
                if spans[k].name == "mesh.extract" and spans[k].parent < 0}
    waits = [s for s in win if s.wait and _under(spans, s, extracts)]
    out["mesh_wait_ms"] = 1e3 * sum(s.seconds for s in waits) / len(extracts) \
        if extracts else None
    out["host_work_idle.export"] = (host_work_idle(spans, trace, offset_ns, thread)
                                    if trace is not None and offset_ns is not None
                                    and extracts else None)
    cond = [s.seconds for s in win if s.name == "map.cond"]
    out["map_cond_ms_per_frame"] = 1e3 * sum(cond) / n if cond and n else None
    cond = [s.seconds for s in win if s.name == "mesh.cond" and _under(spans, s, extracts)]
    out["mesh_cond_ms"] = 1e3 * sum(cond) / len(extracts) if cond and extracts else None
    return out


def by_name(spans, first: Window) -> Dict[str, Tuple[float, float]]:
    """Each span name's total and self time (less its children), ms a frame
    or extract of the first window."""
    keep = _inside(spans, first)
    n = max(first.items(), 1)
    out: Dict[str, list] = {}
    for k in keep:
        out.setdefault(spans[k].name, [0.0, 0.0])[0] += spans[k].seconds
    for a, b, s in _self_intervals(spans, keep):
        out[s.name][1] += (b - a) * 1e-9
    return {name: (1e3 * t / n, 1e3 * own / n) for name, (t, own) in sorted(out.items())}


def _under(spans, s, roots: set) -> bool:
    p = s.parent
    while p >= 0:
        if p in roots:
            return True
        p = spans[p].parent
    return False


def run(workload: str, seed: int, seconds: float, trace: bool, device, spec=None) -> dict:
    """The cell's result with the recorder on, and the span readings."""
    from benchmark import run as bench_run
    from benchmark import drive
    from benchmark import trace as bench_trace
    from difusion_tpu_torch.utils import tracing

    spec = spec or bench_run.cell_spec(bench_run.load_manifest(), workload)
    windows: List[Window] = []
    drivers = {k: watched(v, windows) for k, v in drive.DRIVERS.items()}
    traces = []

    class Trace(bench_trace.Trace):
        def __init__(self, prof, t0_perf):
            super().__init__(prof, t0_perf)
            self.port_offset_ns = tracing.clock_offset_ns(
                (e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events())
            traces.append(self)

    tracing.reset()
    tracing.enable()
    original = bench_trace.Trace
    bench_trace.Trace = Trace
    try:
        result = bench_run.run_cell(spec, seed, seconds, trace, device, drivers=drivers)
    finally:
        bench_trace.Trace = original
        tracing.disable()
    spans = tracing.spans()
    tr = traces[0] if traces else None
    result["spans"] = readings(spans, windows[0], tr, tr.port_offset_ns if tr else None,
                               threading.get_ident())
    result["window"] = windows[0].out
    result["launches"] = windows[0].launches
    result["decode_instance"] = windows[0].instance
    result["cond_rows"] = windows[0].cond_rows
    result["by_name"] = by_name(spans, windows[0])
    n = windows[0].items()
    result["segment_ms"] = {k: 1e-6 * v / n for k, v in windows[0].segments.items()} \
        if n else {}
    if tr is not None:
        result["clock_offset_ns"] = {"recorder": tr.port_offset_ns, "benchmark": tr.offset_ns}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trace_cells: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), device)
    print(json.dumps(result, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
