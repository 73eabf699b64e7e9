"""Percent of the traced window of back-to-back extracts in which no
operation ran on the card (the union of the profiler's device records;
the mesher launches eagerly, so each is recorded)."""


def read(ctx):
    return ctx.idle_percent()
