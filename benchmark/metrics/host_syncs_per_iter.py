"""Points an iteration at which the solve waited for the device to hand
the host a value (the solves' n_host_syncs over their iterations)."""


def read(ctx):
    iters = ctx.total("n_iters")
    return ctx.total("n_host_syncs") / iters if iters else None
