"""The objective's value and gradient over one batch of the mix's size,
as vag_roofline.full_batch, %."""


def read(ctx):
    return ctx.roofline("vag")
