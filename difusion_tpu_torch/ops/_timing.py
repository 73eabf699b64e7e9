"""Timing of calls that launch CUDA kernels, for the scripts that measure the
port on a card (``chip_smoke.py``, ``stencil_tune.py``).  Nothing on a path
of the port calls these."""
from __future__ import annotations

import statistics
import time

import torch


def time_ms(fn, batches: int, per_batch: int = 10) -> float:
    """Per-call ms: the median over ``batches`` of CUDA-event-timed runs of
    ``per_batch`` back-to-back calls (after 3 warm-up calls).  Timing a run
    of calls, not one, keeps the host's launch latency out of a kernel's
    time as long as the host enqueues faster than the card computes."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_batch)
    return statistics.median(times)


def graph_ms(fn, calls: int, reps: int = 10) -> float:
    """Device ms per call: ``calls`` back-to-back calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events (median).  Replay
    keeps the host's per-call cost (ctypes, allocation, checks) out of the
    time, which event timing of eager calls does not once a kernel is
    shorter than its wrapper."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def host_us(fn, calls: int = 100) -> float:
    """The host's us per eager call: the wall time to enqueue ``calls``
    calls, the card's work synchronised outside the clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6
