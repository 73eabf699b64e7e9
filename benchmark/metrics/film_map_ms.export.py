"""The mapping kernel's device milliseconds an extract: the time the profiler
gives the launches whose name holds ``film_map_kernel`` (pigan_film's mapping
network over the live blocks' codes, once an extract), over the extracts of
the traced window.  None where no such kernel ran (a decoder family without
a mapping network)."""


def read(ctx):
    n, secs = ctx.trace.kernel_time("film_map_kernel")
    extracts = ctx.counts.get("extracts", 0)
    if not n or secs <= 0 or not extracts:
        return None
    return 1e3 * secs / extracts
