"""The conditioning kernel's device milliseconds a tracked frame: the time
the profiler gives the launches whose name holds ``cbn_cond_kernel``
(onet_cbn's refresh of the map slots' conditioning after each fusion, eager
between the frames' graph launches), over the frames of the traced window.
None where no such kernel ran."""


def read(ctx):
    n, secs = ctx.trace.kernel_time("cbn_cond_kernel")
    if not n or secs <= 0 or not ctx.frames():
        return None
    return 1e3 * secs / ctx.frames()
