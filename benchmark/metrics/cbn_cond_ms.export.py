"""The conditioning kernel's device milliseconds an extract: the time the
profiler gives the launches whose name holds ``cbn_cond_kernel`` (onet_cbn's
conditioning of the live blocks, once an extract), over the extracts of the
traced window.  None where no such kernel ran (a decoder family without
per-code conditioning)."""


def read(ctx):
    n, secs = ctx.trace.kernel_time("cbn_cond_kernel")
    extracts = ctx.counts.get("extracts", 0)
    if not n or secs <= 0 or not extracts:
        return None
    return 1e3 * secs / extracts
