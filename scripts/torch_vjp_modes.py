"""The port's VJP of one step in three modes: the VJP kernel
(ops/csrc/fused_step.cu, reverse mode on a tape), reverse-mode autograd of
the plain version and its forward-mode AD (ops/vjp_check.py::
forward_mode_vjp). Prints, for each model of
tests/test_torch_cuda.py::KERNEL_MODELS at B = 1024 and for the
half-cheetah at chip_smoke.py's inputs and at the main path's standing
start (B = 4096), the per-env relative error of the kernel and of forward
mode against reverse mode (median / p90 / p99, max) and the share of envs
within 1e-6, 1e-4 and 1e-2, next to an all-zero and an env-permuted VJP.
Imports no JAX.

    python scripts/torch_vjp_modes.py

On a CUDA machine it runs the kernel in float32 and float64; without one,
the kernel's host build (g++) in float64 at B = 32.
"""
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from diffdart_tpu_torch.models import cheetah_init_q, half_cheetah  # noqa: E402
from diffdart_tpu_torch.ops import fused_step as fs  # noqa: E402
from diffdart_tpu_torch.ops import vjp_check as vc  # noqa: E402
from test_torch_cuda import KERNEL_MODELS, inputs  # noqa: E402

CUDA = torch.cuda.is_available()
DEV = "cuda" if CUDA else "cpu"


def soa(xs, dtype):
    return [torch.tensor(np.ascontiguousarray(x.T), dtype=dtype, device=DEV) for x in xs]


def sync():
    if CUDA:
        torch.cuda.synchronize()


def kernel_vjp(step, model, q, v, tau, gq, gv):
    if CUDA:
        return fs.VJP_KERNEL(*step.descriptor(q.device, q.dtype), q, v, tau, gq, gv,
                             step.tape_capacity(q, v, tau))
    return fs.host_kernel_vjp(model, q, v, tau, gq, gv)[0]


def quantiles(r):
    return " / ".join(f"{r.quantile(p).item():.2e}" for p in (0.5, 0.9, 0.99)) + f", max {r.max().item():.2e}"


def share(r, tol):
    return f"{100 * (r <= tol).double().mean().item():.2f}%"


def report(tag, model, q, v, tau, gq, gv):
    step = fs.build_fused_step(model)
    got = kernel_vjp(step, model, q, v, tau, gq, gv)
    sync()
    t0 = time.perf_counter()
    fwd = vc.forward_mode_vjp(step.plain, q, v, tau, gq, gv)
    sync()
    t_fwd = time.perf_counter() - t0
    xs = [x.clone().requires_grad_(True) for x in (q, v, tau)]
    rev = torch.autograd.grad(step.plain(*xs), xs, (gq, gv))
    rk, rf = vc.env_rel_err(got, rev), vc.env_rel_err(fwd, rev)
    rz = vc.env_rel_err([torch.zeros_like(x) for x in got], rev)
    rp = vc.env_rel_err([x.roll(1, 1) for x in got], rev)
    print(f"{tag}: forward mode {t_fwd:.2f} s | kernel vs reverse mode {quantiles(rk)}; within "
          f"1e-6 {share(rk, 1e-6)}, 1e-4 {share(rk, 1e-4)}, 1e-2 {share(rk, 1e-2)} | forward vs "
          f"reverse mode {quantiles(rf)}; within 1e-2 {share(rf, 1e-2)} | zero VJP median "
          f"{rz.median().item():.2e}, permuted median {rp.median().item():.2e}", flush=True)


def main():
    if CUDA:
        print(torch.cuda.get_device_name(0), flush=True)
    for dtype in (torch.float32, torch.float64) if CUDA else (torch.float64,):
        B = 1024 if CUDA else 32
        for name in sorted(KERNEL_MODELS):
            m, q0 = KERNEL_MODELS[name](dtype, DEV)
            rng = np.random.RandomState(9)
            g = soa((rng.randn(B, m.nq), rng.randn(B, m.nv)), dtype)
            report(f"{name} {dtype} B={B}", m, *soa(inputs(q0, m.nq, m.nv, B, 8), dtype), *g)
        if not CUDA:
            continue
        m = half_cheetah(dt=2e-3, dtype=dtype, device=DEV)
        B = 4096
        rng = np.random.RandomState(0)  # chip_smoke.py's inputs
        q0 = cheetah_init_q(m).cpu().numpy()
        q = np.tile(q0, (B, 1)) + 0.02 * rng.randn(B, m.nq)
        v, tau = 0.2 * rng.randn(B, m.nv), 0.5 * rng.randn(B, m.nv)
        rng = np.random.RandomState(2)
        gq, gv = rng.randn(B, m.nq), rng.randn(B, m.nv)
        report(f"half_cheetah {dtype} B={B}, chip_smoke inputs", m, *soa((q, v, tau, gq, gv), dtype))
        tau0 = 0.1 * np.random.RandomState(1).randn(B, m.nv)
        report(f"half_cheetah {dtype} B={B}, standing start", m,
               *soa((np.tile(q0, (B, 1)), np.zeros((B, m.nv)), tau0, gq, gv), dtype))


if __name__ == "__main__":
    main()
