"""Median latency (ms) of the frames that fused and meshed: every
``integrate_interval``-th frame of the stream, hand-off to pose on the
host, in the run's untraced window."""
import numpy as np


def read(ctx):
    every = int(ctx.cfg["integrate_interval"])
    lat = [ctx.driver.latency[k] for k in ctx.host_frames if k % every == 0]
    return 1e3 * float(np.median(lat)) if lat else None
