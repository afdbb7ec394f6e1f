"""The objective's value and gradient over the whole training set: its
operations at the f32 peak (or its bytes at the HBM rate, whichever is
longer) over the time of a call replayed from a CUDA graph, %."""


def read(ctx):
    return ctx.roofline("vag")
