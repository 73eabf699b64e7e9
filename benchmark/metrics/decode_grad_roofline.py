"""Kernel 1 (decoder forward + d sdf/d xyz) as a share of its roofline:
each recorded launch's bound at the point budget (the model's FLOPs counted
once, bytes read and written once, both by the prior's decoder family,
:mod:`benchmark.flops`) over the time the profiler gives the launches it
records.  Inside the tracker's graph the profiler records one pass of each
WHILE loop; each record is still one whole launch.

The kernel-name rule: every launch whose name holds ``decode_grad_kernel``
counts, the 128-wide instance, the wide ones (``decode_grad_kernel_wide``)
and any kernel 1 of a new decoder family, whose name holds the stem too."""


def read(ctx):
    n, secs = ctx.trace.kernel_time("decode_grad_kernel")
    if not n or secs <= 0:
        return None
    f, hyper = ctx.flops, ctx.hyper
    pts = int(ctx.cfg["assumed"]["point_budget"])
    work = (pts * f.decoder_grad_flops(hyper), f.decode_grad_bytes(hyper, pts))
    return f.roofline_share([work] * n, ctx.peaks, secs)
