"""The two-loop dispatch's share of its roofline on the full-batch
solver's filled history: the least time (history read once at the
HBM rate, or its operations at the f32 peak) over the time of a call
with the L2 flushed, %."""


def read(ctx):
    return ctx.roofline("two_loop")
