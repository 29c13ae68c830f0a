"""Forward env-steps per second: every env and step of every rollout
completed in the window, over the whole window."""

UNIT = "env-steps/s"


def read(ctx):
    return None if ctx.grad else ctx.window.rate(ctx.env_steps)
