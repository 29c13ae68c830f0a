"""A kernel's share of its roofline over the traced window: the least time
the window's env-steps need on the card, the larger of bytes over the
peak bandwidth and operations over the peak rate, divided by the device
time of the kernels whose names match. The work per env-step and the peaks
are the configuration's frozen numbers (portbench/count_work.py), so the
share reads the same whatever code computes a step. None where the trace
holds no such kernel or the configuration has no count for it."""
from __future__ import annotations

import re


def share_pct(ctx, work_key: str, pattern: str):
    work = ctx.config.get("work", {}).get(work_key)
    if work is None or ctx.trace is None:
        return None
    seconds, launches = ctx.trace.kernel_seconds(re.compile(pattern))
    if not launches or seconds <= 0:
        return None
    peaks = ctx.config["peaks"]
    env_steps = ctx.env_steps * ctx.window.completed
    least = max(env_steps * work["bytes"] / peaks["bytes_per_s"],
                env_steps * work["ops"] / peaks["ops_per_s"])
    return 100.0 * least / seconds
