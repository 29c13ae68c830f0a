"""Kernel 1's share of its roofline (harness/roofline.py)."""
from portbench.harness.roofline import share_pct

UNIT = "%"
LAYER = "fused step kernels (ops/csrc/fused_step.cu)"
MOVES = "fwd_env_steps_per_s"
KERNELS = r"\bfused_step_kernel\b"


def read(ctx):
    return share_pct(ctx, "fused_step_kernel", KERNELS)
