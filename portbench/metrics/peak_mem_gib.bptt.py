"""Peak device memory of the run (torch.cuda.max_memory_allocated over the
set-up and the window, before the check), in GiB: the VJP's tape above
all."""

UNIT = "GiB"
LAYER = "device memory"
MOVES = "bptt_env_steps_per_s"


def read(ctx):
    if not ctx.grad or not ctx.memory_peak_bytes:
        return None
    return ctx.memory_peak_bytes / 2**30
