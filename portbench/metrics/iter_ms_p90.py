"""The 90th percentile of the iteration times of the window, every
iteration counted: the wait per iteration of an optimiser or MPC loop."""

UNIT = "ms"


def read(ctx):
    return ctx.window.percentile_ms(90)
