"""Kernel 1 (decoder forward + d sdf/d xyz, ``decode_grad_kernel``) as a
share of its roofline: each recorded launch's bound at the point budget
(the model's FLOPs counted once, bytes read and written once) over the time
the profiler gives the launches it records.  Inside the tracker's graph the
profiler records one pass of each WHILE loop; each record is still one
whole launch."""


def read(ctx):
    n, secs = ctx.trace.kernel_time("decode_grad_kernel")
    if not n or secs <= 0:
        return None
    f, hyper = ctx.flops, ctx.hyper
    pts = int(ctx.cfg["assumed"]["point_budget"])
    work = (pts * f.decoder_grad_flops(hyper), f.decode_grad_bytes(hyper, pts))
    return f.roofline_share([work] * n, ctx.peaks, secs)
