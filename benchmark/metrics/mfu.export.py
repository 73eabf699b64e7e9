"""The export's model FLOPs as a share of the card's f32-input matrix peak:
the decoder forward over every live block's (2r)^3 lattice, each extract,
over the traced window."""


def read(ctx):
    f, hyper = ctx.flops, ctx.hyper
    r = int(ctx.traffic["resolution"])
    work = (ctx.counts.get("extracts", 0) * ctx.driver.blocks() * (2 * r) ** 3
            * f.decoder_fwd_flops(hyper))
    w = ctx.window_s()
    return 100.0 * work / (w * ctx.peaks["tf32_flops_per_s"]) if work and w > 0 else None
