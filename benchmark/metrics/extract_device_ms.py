"""Device busy milliseconds of one full extract: the union of the traced
window's device intervals (eager launches: the profiler records each), over
the extracts in it."""


def read(ctx):
    n = ctx.counts.get("extracts", 0)
    busy = ctx.trace.busy_s()
    return 1e3 * busy / n if n and busy > 0 else None
