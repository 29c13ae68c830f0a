"""The share of the traced window in which no kernel, copy or fill ran on
the device (forward cells)."""

UNIT = "%"
LAYER = "device"
MOVES = "fwd_env_steps_per_s"


def read(ctx):
    if ctx.trace is None or ctx.grad:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
