"""Kernel 3 (decoder forward over the meshing lattice) as a share of its
roofline: the bound of the sites the extracts need (the live blocks'
(2r)^3 lattices, not the bucket's padding; FLOPs and bytes by the prior's
decoder family, :mod:`benchmark.flops`) over the time of the launches the
profiler records.

The kernel-name rule: every launch whose name holds ``decode_fwd_kernel``
counts, the 128-wide instance, the wide ones (``decode_fwd_kernel_wide``)
and any kernel 3 of a new decoder family, whose name holds the stem too."""


def read(ctx):
    n, secs = ctx.trace.kernel_time("decode_fwd_kernel")
    extracts = ctx.counts.get("extracts", 0)
    if not n or secs <= 0 or not extracts:
        return None
    f, hyper = ctx.flops, ctx.hyper
    r = int(ctx.traffic["resolution"])
    sites = extracts * ctx.driver.blocks() * (2 * r) ** 3
    work = (sites * f.decoder_fwd_flops(hyper), f.decode_fwd_bytes(hyper, sites))
    return f.roofline_share([work], ctx.peaks, secs)
