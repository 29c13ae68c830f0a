"""The fused path's timings of chip_smoke.py (phases 2, 5 and 9) alone, on
one NVIDIA GPU, for the port in this checkout or in another one:
half-cheetah, B = 4096, T = 50, tau = 0.1 N(0,1), float32, standing start,
the same inputs as chip_smoke. Imports no JAX.

    python scripts/torch_fused_timing.py [--repo DIR] [--label NAME]

--repo imports diffdart_tpu_torch from DIR (default: this checkout), so two
trees can be compared in one call on one card: run parent, change, change,
parent. Prints one JSON line: ptxas's registers and stack of the step and
VJP kernels (float32); the step kernel's time between CUDA events through
its wrapper (50 steps) and from its bare C launcher, with the launch that
stops after the front end and the shared memory and warps per SM where the
tree's launcher has them, and both again at fewer warps per SM (launches
that reserve the shared memory of a larger D and nv than the model's, so
that fewer envs fit on an SM: the same work at a lower occupancy); the VJP
kernel's bare-launcher time, whole, its
recording without the sweep and its counting launch, as the BPTT launches
it (at the step kernel's saved LCP solution where the tree has one; the
same three solving the LCP themselves beside them, `_solving`); the
forward rollout (3 runs) and the BPTT (loss + backward, median of 5) with
their env-steps/s.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T = 4096, 50


class UnsavedSolutionLaunchers:
    """The float32 launchers of a tree whose VJP solves the LCP itself (no
    VJP_KERNEL.self_solved): they take this tree's arguments less the step's
    solution pointer and the VJP's pointer and row width, null here."""

    def __init__(self, lib):
        def fused_step_f32(*a):
            assert a[7] is None
            return lib.fused_step_f32(*a[:7], *a[8:])

        def fused_step_vjp_f32(*a):
            assert a[5] is None
            return lib.fused_step_vjp_f32(*a[:5], *a[6:-2], a[-1])

        self.fused_step_f32, self.fused_step_vjp_f32 = fused_step_f32, fused_step_vjp_f32


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fused_timing: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import bare_ms, cuda_ms, ptxas_lines, step_device_ms, vjp_device_ms

    sys.path.insert(0, os.path.abspath(args.repo))
    from diffdart_tpu_torch.dynamics.model import State
    from diffdart_tpu_torch.models import cheetah_init_q, half_cheetah
    from diffdart_tpu_torch.ops import fused_step as fs
    from diffdart_tpu_torch.sim.fast import rollout_fast

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = fs._load("cuda")
    ptx = ptxas_lines(lib)
    saves_solution = hasattr(fs.VJP_KERNEL, "self_solved")
    if hasattr(fs, "occupancy") and not saves_solution:
        lib = UnsavedSolutionLaunchers(lib)
    m = half_cheetah(dt=2e-3, dtype=torch.float32, device="cuda")
    step = fs.build_fused_step(m)
    taus = torch.tensor(0.1 * np.random.RandomState(1).randn(T, B, m.nv), dtype=torch.float32,
                        device="cuda")
    q0 = cheetah_init_q(m).repeat(B, 1)
    state = State(q=q0, v=torch.zeros(B, m.nv, device="cuda"), t=torch.zeros(B, device="cuda"))
    qs, vs, ts = fs.to_soa(q0), torch.zeros(m.nv, B, device="cuda"), taus[0].T.contiguous()
    desc = step.descriptor(qs.device, torch.float32)
    out = {"label": args.label, "repo": os.path.abspath(args.repo), "card": card,
           "ptxas_step_f32": ptx.get("fused_step<float>"),
           "ptxas_vjp_f32": ptx.get("fused_step_vjp<float>")}
    with torch.no_grad():
        out["step_wrapper_ms"] = cuda_ms(lambda: step(qs, vs, ts), reps=50)
        if hasattr(fs, "occupancy"):  # one warp per env
            D = step.D
            out["step_ms"] = step_device_ms(lib, desc, D, qs, vs, ts)[0]
            out["step_front_only_ms"] = step_device_ms(lib, desc, D, qs, vs, ts, front_only=True)[0]
            out["step_occupancy_f32"] = fs.occupancy("cuda", torch.float32, D, m.nv)
            out["step_by_warps_per_sm"] = [
                [fs.occupancy("cuda", torch.float32, Dr, nvr)["warps_per_sm"],
                 step_device_ms(lib, desc, Dr, qs, vs, ts, sized=nvr)[0],
                 step_device_ms(lib, desc, Dr, qs, vs, ts, front_only=True, sized=nvr)[0]]
                for Dr, nvr in ((D, m.nv), (64, 16), (90, 16), (130, 16))]
        else:  # one thread per env: (di, df, q, v, tau, qo, vo, B, stream)
            qo, vo = torch.empty_like(qs), torch.empty_like(vs)
            out["step_ms"] = bare_ms(lib.fused_step_f32, (
                *(x.data_ptr() for x in (*desc, qs, vs, ts, qo, vo)), B,
                torch.cuda.current_stream().cuda_stream), reps=50)[0]
        out["rollout_ms"] = cuda_ms(lambda: rollout_fast(m, state, taus), reps=3)
    cap = step.tape_capacity(qs, vs, ts)
    g = (torch.ones_like(qs), torch.ones_like(vs))
    saved = None
    if saves_solution:
        with torch.no_grad():
            saved = step_device_ms(lib, desc, step.D, qs, vs, ts, reps=1, solution=True)[2][2]
    for part in ("whole", "record", "count"):
        out[f"vjp_{part}_ms"] = vjp_device_ms(lib, desc, qs, vs, ts, *g, cap, part=part,
                                              solution=saved)[0]
        if saved is not None:
            out[f"vjp_{part}_solving_ms"] = vjp_device_ms(lib, desc, qs, vs, ts, *g, cap, part=part)[0]

    def bptt():
        taus_g = taus.clone().requires_grad_(True)
        fin = rollout_fast(m, state, taus_g)
        ((fin.q[:, 1] ** 2).mean() + 1e-4 * (taus_g**2).mean()).backward()

    bptt()
    runs = sorted(cuda_ms(bptt, reps=1) for _ in range(5))
    out["bptt_ms"], out["bptt_runs_ms"] = runs[2], runs
    out["fwd_env_steps_per_s"] = B * T / (out["rollout_ms"] * 1e-3)
    out["fwd_grad_env_steps_per_s"] = B * T / (out["bptt_ms"] * 1e-3)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
