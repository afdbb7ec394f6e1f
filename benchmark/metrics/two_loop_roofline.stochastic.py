"""The two-loop dispatch's share of its roofline on the stochastic
solver's filled history (clamped gamma), as two_loop_roofline.full_batch, %."""


def read(ctx):
    return ctx.roofline("two_loop")
