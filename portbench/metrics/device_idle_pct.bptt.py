"""The share of the traced window in which no kernel, copy or fill ran on
the device (BPTT cells)."""

UNIT = "%"
LAYER = "device"
MOVES = "bptt_env_steps_per_s"


def read(ctx):
    if ctx.trace is None or not ctx.grad:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
