"""Milliseconds an iteration: the window's wall time over the iterations
its whole solves completed."""


def read(ctx):
    iters = ctx.total("n_iters")
    return ctx.window_s * 1e3 / iters if iters else None
