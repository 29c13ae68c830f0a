"""The vmap stack's timings of chip_smoke.py (phases 14-16) alone, on one
NVIDIA GPU, for the port in this checkout or in another one: half-cheetah,
B = 4096, T = 50, tau = 0.1 N(0,1), float32, standing start, the same
inputs as chip_smoke. Imports no JAX.

    python scripts/torch_vmap_timing.py [--repo DIR] [--label NAME]

--repo imports diffdart_tpu_torch from DIR (default: this checkout), so two
trees can be compared in one call on one card: run parent, change, change,
parent. Prints one JSON line: the vmap step's time between CUDA events (5
steps) and the host's time to issue one (5 steps, waited for afterwards),
the vmap rollout (2 runs), step_batched (5 steps), the fallback BPTT with
the mass gradient (2 runs), and from a torch.profiler trace of 3 vmap
steps: the device's busy time per step (the sum of its kernels' and copies'
durations), its idle share against the step's event time, the kernels and
device-to-host copies per step, and the five kernels that take the most
time.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

B, T = 4096, 50


def cuda_ms(fn, reps):
    """Mean time between CUDA events per fn() call, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    """Mean host time of issuing fn() per call, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    out = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return out


def device_profile(fn, steps):
    """(busy ms per step, kernels per step, device-to-host copies per step,
    the five kernels with the most time as [name, ms per step]) from a
    torch.profiler trace of `steps` calls of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in dev if "memcpy" in e.name.lower() or "memset" in e.name.lower()]
    d2h = [e for e in copies if "dtoh" in e.name.lower().replace(" ", "").replace("-", "")]
    kernels = [e for e in dev if e not in copies]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / steps
    return busy, len(kernels) / steps, len(d2h) / steps, [[n[:80], ms] for n, ms in top]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_vmap_timing: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    from diffdart_tpu_torch.dynamics.model import State
    from diffdart_tpu_torch.models import cheetah_init_q, half_cheetah
    from diffdart_tpu_torch.ops import pallas_lcp as P
    from diffdart_tpu_torch.sim import step as S
    from diffdart_tpu_torch.sim.batched import step_batched
    from diffdart_tpu_torch.sim.fast import rollout_fast

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    m32 = half_cheetah(dt=2e-3, dtype=torch.float32, device="cuda")
    m32p = m32.replace(contact_solver="lowrank_pallas")
    taus = torch.tensor(0.1 * np.random.RandomState(1).randn(T, B, m32.nv), dtype=torch.float32,
                        device="cuda")
    state = State(q=cheetah_init_q(m32).repeat(B, 1), v=torch.zeros(B, m32.nv, device="cuda"))

    def vmap_bptt():
        mass = m32p.mass.clone().requires_grad_(True)
        taus_g = taus.clone().requires_grad_(True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fin = rollout_fast(m32p.replace(mass=mass), state, taus_g)
        ((fin.q[:, 1] ** 2).mean() + 1e-4 * (taus_g**2).mean()).backward()

    def vstep():
        S.step(m32p, state, taus[0])

    P.KERNEL_SINGLE.launches = 0
    with torch.no_grad():
        out = {
            "label": args.label, "repo": os.path.abspath(args.repo), "card": card,
            "vmap_step_ms": cuda_ms(vstep, reps=5),
            "vmap_step_host_ms": host_ms(vstep, reps=5),
            "vmap_rollout_ms": cuda_ms(lambda: S.rollout(m32p, state, taus), reps=2),
            "step_batched_ms": cuda_ms(lambda: step_batched(m32, state, taus[0]), reps=5),
        }
        busy, kernels, d2h, top = device_profile(vstep, steps=3)
    out["vmap_bptt_ms"] = cuda_ms(vmap_bptt, reps=2)
    check = P.KERNEL_SINGLE.launches > 0
    out.update({
        "fwd_env_steps_per_s": B * T / (out["vmap_rollout_ms"] * 1e-3),
        "fwd_grad_env_steps_per_s": B * T / (out["vmap_bptt_ms"] * 1e-3),
        "vmap_step_device_busy_ms": busy,
        "vmap_step_idle_share": 1.0 - busy / out["vmap_step_ms"],
        "vmap_step_kernels": kernels, "vmap_step_dtoh_copies": d2h, "vmap_step_top_kernels": top,
        "sweep_kernel_launched": check,
    })
    print(json.dumps(out))
    return 0 if check else 1


if __name__ == "__main__":
    sys.exit(main())
