"""Points an epoch at which the solve waited for the device to hand the
host a value (the solves' n_host_syncs over their epochs)."""


def read(ctx):
    epochs = ctx.total("n_iters")
    return ctx.total("n_host_syncs") / epochs if epochs else None
