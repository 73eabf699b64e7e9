"""Kernel 3's device milliseconds an extract: the time the profiler gives
the launches whose name holds ``decode_fwd_kernel`` (the 128-wide instance
and the wide ones alike), over the extracts of the traced window.

The kernel-name rule: any kernel 3 of a new decoder family holds the stem
``decode_fwd_kernel`` in its name, and counts here."""


def read(ctx):
    n, secs = ctx.trace.kernel_time("decode_fwd_kernel")
    extracts = ctx.counts.get("extracts", 0)
    if not n or secs <= 0 or not extracts:
        return None
    return 1e3 * secs / extracts
