"""Forward+gradient env-steps per second: every env and step of every
iteration completed in the window (rollout, loss and backward to the control
tape), over the whole window."""

UNIT = "env-steps/s"


def read(ctx):
    return ctx.window.rate(ctx.env_steps) if ctx.grad else None
