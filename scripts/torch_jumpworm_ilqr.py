"""The jump-worm's iLQR on the torch port: the counterpart of
examples/jumpworm_ilqr.py at its configuration. Imports no JAX.

    python scripts/torch_jumpworm_ilqr.py [--device cuda|cpu] [--iters 20]

A planar 3-link worm (dt 5e-3, float32 with the LCP solve in float64,
lcp_dtype='f64'; on the card contact_solver='lowrank_pallas') rests on the
ground after 100 zero-torque steps; iLQR (trajectory/ilqr.py) over T = 60
steps of torque-squashed controls u = 6 tanh(w / 6) on its two hinges,
from an out-of-phase pumping warm start, maximizes the end height and
upward velocity (terminal cost -20 z - 5 vz, running cost 2e-3 |w|^2).
Success: the apex of the root's height more than 0.08 m above rest, with
no tunnelling (lowest > 0, apex < 1 m). Prints the heights, ms per
iteration and the share of it spent in the batched linearization, and
one JSON line last.
"""
import argparse
import importlib
import json
import math
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from diffdart_tpu_torch.dynamics.model import State  # noqa: E402
from diffdart_tpu_torch.models import jump_worm  # noqa: E402
from diffdart_tpu_torch.sim.step import step  # noqa: E402
ilqr_mod = importlib.import_module("diffdart_tpu_torch.trajectory.ilqr")

U_MAX = 6.0
T = 60


def build(device):
    m = jump_worm(dt=5e-3, n_links=3, dtype=torch.float32, device=device).replace(lcp_dtype="f64")
    if device == "cuda":
        m = m.replace(contact_solver="lowrank_pallas")
    return m


def problem(m):
    """(f, running cost, terminal cost, x0 at rest, the pumping warm start)."""
    nq = m.nq

    def f(x, w):
        xb, wb = x.reshape(-1, x.shape[-1]), w.reshape(-1, w.shape[-1])
        u = U_MAX * torch.tanh(wb / U_MAX)
        tau = torch.cat([torch.zeros(xb.shape[0], 3, dtype=x.dtype, device=x.device), u], dim=1)
        s = step(m, State(q=xb[:, :nq], v=xb[:, nq:]), tau)
        return torch.cat([s.q, s.v], dim=-1).reshape(x.shape)

    def rc(x, w, t):
        return 2e-3 * torch.sum(w**2)

    def tc(x):
        return -20.0 * x[0] - 5.0 * x[nq]

    q0 = m.neutral_q().clone()
    q0[0] = 0.045
    x = torch.cat([q0, torch.zeros(m.nv, dtype=q0.dtype, device=q0.device)])
    with torch.no_grad():
        for _ in range(100):
            x = f(x, torch.zeros(2, dtype=x.dtype, device=x.device))
    t = torch.arange(T, dtype=x.dtype, device=x.device)[:, None] * 5e-3
    us0 = 2.5 * torch.sin(2 * math.pi * 2.5 * t + torch.tensor([[0.0, 3.14]], dtype=x.dtype,
                                                                 device=x.device))
    return f, rc, tc, x, us0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("torch_jumpworm_ilqr: no CUDA device")
    m = build(args.device)
    f, rc, tc, x0, us0 = problem(m)
    rest = float(x0[0])
    lin_s = [0.0]
    inner = ilqr_mod._linearize

    def timed_linearize(*a, **k):
        if args.device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        if args.device == "cuda":
            torch.cuda.synchronize()
        lin_s[0] += time.perf_counter() - t0
        return out

    ilqr_mod._linearize = timed_linearize
    t0 = time.perf_counter()
    res = ilqr_mod.ilqr(f, rc, tc, x0, us0, iters=args.iters)
    if args.device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ilqr_mod._linearize = inner
    apex, lowest = float(res.xs[:, 0].max()), float(res.xs[:, 0].min())
    ok = apex > rest + 0.08 and lowest > 0.0 and apex < 1.0
    print(f"worm root height: rest {rest:.3f} -> apex {apex:.3f} m (lowest {lowest:.3f})")
    print("SUCCESS" if ok else "FAILED", f": the worm jumped {apex - rest:.3f} m (success at > 0.08)")
    out = dict(script="torch_jumpworm_ilqr", device=args.device,
               gpu=torch.cuda.get_device_name(0) if args.device == "cuda" else None,
               iters=args.iters, rest=rest, apex=apex, lowest=lowest, success=ok, wall_s=wall,
               ms_per_iter=1e3 * wall / max(args.iters, 1), linearize_share=lin_s[0] / wall,
               cost_trace=[float(c) for c in res.cost_trace])
    print(json.dumps(out))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
