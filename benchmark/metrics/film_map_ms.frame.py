"""The mapping kernel's device milliseconds a tracked frame: the time the
profiler gives the launches whose name holds ``film_map_kernel``
(pigan_film's refresh of the map slots' modulation after each fusion, eager
between the frames' graph launches), over the frames of the traced window.
None where no such kernel ran."""


def read(ctx):
    n, secs = ctx.trace.kernel_time("film_map_kernel")
    if not n or secs <= 0 or not ctx.frames():
        return None
    return 1e3 * secs / ctx.frames()
