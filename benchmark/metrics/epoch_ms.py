"""Milliseconds an epoch: the window's wall time over the epochs its
whole solves completed."""


def read(ctx):
    epochs = ctx.total("n_iters")
    return ctx.window_s * 1e3 / epochs if epochs else None
