"""The full-batch window's required operations (benchmark.counts, from
shapes and the solves' counters) over its time at the f32 peak, %."""


def read(ctx):
    return ctx.flops_share()
