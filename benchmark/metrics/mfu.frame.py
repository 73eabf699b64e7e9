"""The tracked stream's model FLOPs as a share of the card's f32-input
matrix peak: the SDF term's decoder forward + d sdf/d xyz over the point
budget for every device-counted evaluation of a group with an SDF term,
and the encoder over the 8 voxel rows of every budget point of each fusion
(:mod:`benchmark.flops`), over the traced window."""


def read(ctx):
    f, hyper = ctx.flops, ctx.hyper
    pts = int(ctx.cfg["assumed"]["point_budget"])
    work = (ctx.counts.get("sdf_evals", 0) * pts * f.decoder_grad_flops(hyper)
            + ctx.fusions() * 8 * pts * f.encoder_flops(hyper))
    w = ctx.window_s()
    return 100.0 * work / (w * ctx.peaks["tf32_flops_per_s"]) if work and w > 0 else None
