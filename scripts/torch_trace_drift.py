"""How many kernel events a torch.profiler trace loses as the process ages,
on one NVIDIA GPU. Imports no JAX.

    python scripts/torch_trace_drift.py LABEL SECONDS
    TEARDOWN_CUPTI=1 python scripts/torch_trace_drift.py LABEL SECONDS

Every 15 s until SECONDS of process age, one plain torch.profiler trace
(CPU and CUDA activity) of rollout_fast on the half-cheetah (B = 4096,
T = 50, float32, chip_smoke's phase-5 inputs), checked by
utils/profile.py::lost_kernel_events. Prints one line: LABEL, then per
trace "age:lost/launches(the earliest kept kernel's start minus its
launch, ms)". Several copies with different TEARDOWN_CUPTI settings can
run at once on one card: they mostly sleep.

Kineto leaves CUPTI running across traces unless TEARDOWN_CUPTI=1; CUPTI
maps the card's clock onto the host's when it starts, the two drift apart,
and Kineto drops the kernel events that then fall outside the trace's
window. This is why utils/profile.py::device_trace tears CUPTI down.
"""
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from diffdart_tpu_torch.dynamics.model import State  # noqa: E402
from diffdart_tpu_torch.models import cheetah_init_q, half_cheetah  # noqa: E402
from diffdart_tpu_torch.ops import fused_step as fs  # noqa: E402
from diffdart_tpu_torch.sim.fast import rollout_fast  # noqa: E402
from diffdart_tpu_torch.utils.profile import lost_kernel_events, named_scope  # noqa: E402

B, T = 4096, 50


def main():
    if not torch.cuda.is_available():
        print("torch_trace_drift: needs a CUDA device", file=sys.stderr)
        return 1
    t0 = time.time()
    label, until = sys.argv[1], float(sys.argv[2])
    fs._load("cuda")
    m32 = half_cheetah(dt=2e-3, dtype=torch.float32, device="cuda")
    state = State(q=cheetah_init_q(m32).repeat(B, 1), v=torch.zeros(B, m32.nv, device="cuda"))
    taus = torch.tensor(0.1 * np.random.RandomState(1).randn(T, B, m32.nv), dtype=torch.float32,
                        device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = []
    while time.time() - t0 < until:
        with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
            rollout_fast(m32, state, taus)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                with named_scope("rollout_fast_T50"):
                    rollout_fast(m32, state, taus)
                torch.cuda.synchronize()
            path = os.path.join(tmp, "t.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                ev = json.load(f)["traceEvents"]
        n, lost = lost_kernel_events(ev)
        launch = {e["args"]["correlation"]: e for e in ev
                  if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
        kern = [e for e in ev if e.get("cat") == "kernel"]
        d = [k["ts"] - launch[k["args"]["correlation"]]["ts"] for k in kern
             if k["args"].get("correlation") in launch]
        out.append(f"{time.time() - t0:.0f}s:{len(lost)}/{n}" + (f"({min(d) / 1e3:+.1f}ms)" if d else ""))
        time.sleep(15)
    print(label, " ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
