"""Line-search trials an iteration beyond the accepted one: the
solves' objective evaluations less their gradient evaluations, over
their iterations."""


def read(ctx):
    iters = ctx.total("n_iters")
    return (ctx.total("n_fevals") - ctx.total("n_gevals")) / iters if iters else None
