"""The device's idle share of a full-batch solve: 1 - the profiler's busy
time over the unprofiled wall time of the same solve, %."""


def read(ctx):
    return ctx.idle_pct()
