"""The mapping kernel as a share of its roofline in the export: its rows are
the extracts' live blocks, each the family's mapping FLOPs (``cond_flops``)
and its code in and modulation out (``cond_row_floats``) at f32, once; their
bound over the time of the launches whose name holds ``film_map_kernel``.
None where no such kernel ran or the prior's family has no per-code
conditioning."""


def read(ctx):
    n, secs = ctx.trace.kernel_time("film_map_kernel")
    extracts = ctx.counts.get("extracts", 0)
    if not n or secs <= 0 or not extracts:
        return None
    fam = ctx.flops.decoders.load(ctx.hyper)
    if not hasattr(fam, "cond_flops"):
        return None
    rows = extracts * ctx.driver.blocks()
    work = (rows * fam.cond_flops(ctx.hyper),
            rows * ctx.flops.F32 * fam.cond_row_floats(ctx.hyper))
    return ctx.flops.roofline_share([work], ctx.peaks, secs)
