"""The device's idle share of a stochastic solve: 1 - the profiler's busy
time over the unprofiled wall time of the same solve, %."""


def read(ctx):
    return ctx.idle_pct()
