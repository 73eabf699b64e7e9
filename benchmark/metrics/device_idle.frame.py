"""Percent of the traced window of a tracked stream in which no operation
ran on the card: one minus the union of device-busy intervals (eager
records, and each graph launch from its first record to its last) over the
window (:mod:`benchmark.trace`)."""


def read(ctx):
    return ctx.idle_percent()
