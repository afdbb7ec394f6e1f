"""Set-up time: the start of the process to the start of the window, s."""


def read(ctx):
    return ctx.setup_s
