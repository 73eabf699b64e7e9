"""Host milliseconds a frame spends in the port's entry: from the call
into ``process_chunk`` / ``process_frame`` to its return (the benchmark's
spans), over the frames of the run's untraced window (the profiler would
slow the host several times over)."""


def read(ctx):
    entry = "process_chunk" if ctx.traffic["entry"] == "chunk" else "process_frame"
    total = sum(e - s for n, s, e in ctx.host_spans if n == entry)
    frames = int(ctx.host_window.get("frames", 0))
    return 1e3 * total / frames if total and frames else None
