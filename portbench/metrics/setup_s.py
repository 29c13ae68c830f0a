"""Set-up: from the process's start to the first timed iteration (imports,
the model's build, the kernels' libraries loaded or built, inputs made from
the seed, the warm-up of the cell's own shapes)."""

UNIT = "s"


def read(ctx):
    return ctx.setup_seconds
