"""The traced window: ``torch.profiler`` over the window, reduced to device
intervals, the card's busy time, and the breakdown.

The port tracks a frame as one launch of an executable CUDA graph whose
loops are conditional WHILE nodes.  The profiler records only one pass of
each WHILE node, so the kernels it reports under-count a graph launch's
time.  A graph runs on the card without a gap for the host, so its launch
is busy from its first kernel to its last: each graph launch counts as the
span of the device records that carry its correlation id (on the card every
launch has some: 144 of 144 in a traced second).  Eager kernels, copies and
sets count as their own intervals.  Busy time is
the union of all of these: overlapping streams count once.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


WINDOW = "bench.window"


class Trace:
    """Device records of a traced window, on the profiler's clock (ns)."""

    def __init__(self, prof, t0_perf: float):
        self.kernels: List[Tuple[str, int, int]] = []     # (name, start, end)
        self.graph_spans: List[Tuple[int, int]] = []
        self.window: Optional[Tuple[int, int]] = None
        runtime: Dict[int, str] = {}
        by_corr: Dict[int, List[Tuple[str, int, int]]] = defaultdict(list)
        events = prof.profiler.kineto_results.events()
        for e in events:
            dt = str(e.device_type())
            start, end = int(e.start_ns()), int(e.start_ns() + e.duration_ns())
            if "CUDA" in dt:
                if e.name() == WINDOW or e.is_user_annotation():
                    continue                  # the window's own mark, not work
                rec = (e.name(), start, end)
                self.kernels.append(rec)
                by_corr[int(e.correlation_id())].append(rec)
                if e.linked_correlation_id():
                    by_corr[int(e.linked_correlation_id())].append(rec)
            else:
                if e.name() == WINDOW:
                    self.window = (start, end)
                if "GraphLaunch" in e.name():
                    runtime[int(e.correlation_id())] = e.name()
        in_graph = set()
        for corr in runtime:
            recs = by_corr.get(corr)
            if recs:
                self.graph_spans.append((min(r[1] for r in recs), max(r[2] for r in recs)))
                in_graph.update(id(r) for r in recs)
        self.eager = [r for r in self.kernels if id(r) not in in_graph]
        self.n_graph_launches = len(runtime)
        self.n_graph_launches_seen = len(self.graph_spans)
        self.offset_ns = (self.window[0] - int(t0_perf * 1e9)) if self.window else 0

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device-busy intervals inside the window."""
        w0, w1 = self.window
        ivs = sorted([(s, e) for _, s, e in self.eager] + self.graph_spans)
        out: List[List[int]] = []
        for s, e in ivs:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        """Seconds the card was busy in the window."""
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_time(self, name_part: str) -> Tuple[int, float]:
        """(records, seconds) of the device records whose name holds
        ``name_part``."""
        recs = [(s, e) for n, s, e in self.kernels if name_part in n]
        return len(recs), sum(e - s for s, e in recs) * 1e-9

    def breakdown(self, spans: List[tuple]) -> dict:
        """The ten device operations that took most time, and the ten
        longest idle gaps named by the host span they fell in."""
        per: Dict[str, float] = defaultdict(float)
        for n, s, e in self.kernels:
            per[n] += (e - s) * 1e-9
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
        busy = self.busy_intervals()
        w0, w1 = self.window
        gaps = []
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
        named = []
        spans_ns = [(n, int(s * 1e9) + self.offset_ns, int(e * 1e9) + self.offset_ns)
                    for n, s, e in spans]
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            # the innermost span the host was in when the card went idle
            inside = [(s0, n) for n, s0, e0 in spans_ns if s0 <= a < e0]
            named.append([max(inside)[1] if inside else "outside the port", (b - a) * 1e-9])
        return {"device_ops": [[n[:160], v] for n, v in ops], "idle_gaps": named}


class Context:
    """What a per-layer metric's reader reads: the driver (its system, its
    configuration and traffic), the traced window's host spans, numbers,
    trace and counters' change, and ``host``: the untraced window's spans,
    numbers and frames (``host_spans``, ``host_window``, ``host_frames``),
    for what the host clock measures."""

    def __init__(self, driver, spans, window: dict, trace: Trace, counts: Dict[str, int],
                 host: tuple):
        from . import flops
        self.driver, self.spans, self.window, self.trace = driver, spans, window, trace
        self.counts = counts
        self.host_spans, self.host_window, self.host_frames = host
        self.cfg, self.traffic = driver.cfg, driver.traffic
        self.peaks = driver.cfg["peaks"]
        hyper_path = driver.cfg["training_hypers"]
        import json
        from pathlib import Path
        self.hyper = json.loads((Path(__file__).resolve().parent.parent
                                 / hyper_path).read_text())
        self.flops = flops

    def frames(self) -> int:
        return int(self.window.get("frames", 0))

    def window_s(self) -> float:
        return self.trace.window_s()

    def idle_percent(self):
        """Percent of the traced window in which no operation ran on the
        card, or None where the trace shows no device work."""
        w = self.window_s()
        busy = self.trace.busy_s()
        return 100.0 * (1.0 - busy / w) if w > 0 and busy > 0 else None

    def fusions(self) -> int:
        every = int(self.cfg["integrate_interval"])
        return sum(1 for k in self.driver.window_frames if k % every == 0)


def traced(driver, seconds: float):
    """Run the driver's window for ``seconds`` under the profiler.  Returns
    (the window's numbers, Trace)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if driver.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            out = driver.window(seconds)
    return out, Trace(prof, t0)
