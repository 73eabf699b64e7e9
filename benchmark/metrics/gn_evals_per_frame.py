"""Gauss-Newton evaluations a tracked frame: the passes of the tracker's
graph-program loops, counted on the card (``GraphProgram.loop_passes``),
over the frames of the traced window."""


def read(ctx):
    n = ctx.counts.get("gn_evals", 0)
    return n / ctx.frames() if n and ctx.frames() else None
