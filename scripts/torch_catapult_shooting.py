"""The catapult's trajectory optimization (BASELINE config 3) on the torch
port: the counterpart of examples/catapult_shooting.py at its
configuration. Imports no JAX.

    python scripts/torch_catapult_shooting.py [--device cuda|cpu] [--iters 200]
                                              [--max-seconds S]

A two-link arm flings a ball out of its cradle; Adam (lr 0.5) optimizes the
arm's torque tape (T = 150 steps of dt 2e-3) by backpropagation through
time, the loss being minus the ball's ballistic landing distance from the
end-of-horizon state plus 1e-5 sum(u^2). Float32 with the LCP solve and
its IFT gradient in float64 (lcp_dtype='f64'); on the card
contact_solver='lowrank_pallas', so every step launches the sweep kernel
(sim/step.py::rollout_checkpointed: one solve per step, the impulse kept
for the backward pass). The hold tape is the gravity-compensating torque
at the initial pose, and the first 40 steps add a swing pulse
(-20, -6 N m). Success: the optimized landing beats the hold's by more
than 5 m. --max-seconds stops the loop after the iteration that passes it
(the result then says how many iterations ran). Prints progress, the
landing distances, ms per iteration (median), the sweep launches per
iteration on the card, and one JSON line last.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from diffdart_tpu_torch.dynamics import dynamics as D  # noqa: E402
from diffdart_tpu_torch.dynamics.model import State  # noqa: E402
from diffdart_tpu_torch.models import catapult, catapult_init_q  # noqa: E402
from diffdart_tpu_torch.sim.step import rollout_checkpointed  # noqa: E402

G = 9.81
T = 150


def build(device):
    m = catapult(dt=2e-3, dtype=torch.float32, device=device).replace(lcp_dtype="f64")
    if device == "cuda":
        m = m.replace(contact_solver="lowrank_pallas")
    return m


def problem(m):
    """(roll(us) -> final State, landing_x(final), the hold tape (T, 2))."""
    q0 = catapult_init_q(m)
    z = torch.zeros(1, m.nv, dtype=q0.dtype, device=q0.device)
    s0 = State(q=q0[None], v=z)
    cache = D.kinematics_cache(m, q0[None], z)
    C = D.bias_forces(m, q0[None], z, cache)[0]
    hold = C[:2].detach()
    ball_r = float(m.geom_size[4, 0])

    def roll(us):
        taus = torch.cat([us, torch.zeros(T, m.nv - 2, dtype=us.dtype, device=us.device)], dim=1)
        return rollout_checkpointed(m, s0, taus[:, None, :])

    def landing_x(final):
        x, zz = final.q[0, 6], final.q[0, 8]
        vx, vz = final.v[0, 3], final.v[0, 5]
        t_fall = (vz + torch.sqrt(torch.clamp(vz**2 + 2 * G * torch.clamp(zz - ball_r, min=0.0),
                                              min=1e-9))) / G
        return x + vx * t_fall

    return roll, landing_x, hold.expand(T, 2).clone()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--max-seconds", type=float, default=float("inf"))
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("torch_catapult_shooting: no CUDA device")
    m = build(args.device)
    roll, landing_x, us_hold = problem(m)
    with torch.no_grad():
        x_hold = float(landing_x(roll(us_hold)))
    us = us_hold.clone()
    us[:40, 0] += -20.0
    us[:40, 1] += -6.0
    us.requires_grad_(True)
    opt = torch.optim.Adam([us], lr=0.5)
    from diffdart_tpu_torch.ops import pallas_lcp as P

    times, launches = [], []
    t_start = time.perf_counter()
    it = 0
    for it in range(args.iters):
        n0 = P.KERNEL_SINGLE.launches
        t0 = time.perf_counter()
        opt.zero_grad()
        final = roll(us)
        loss = -landing_x(final) + 1e-5 * (us**2).sum()
        loss.backward()
        opt.step()
        lv = loss.item()
        times.append(1e3 * (time.perf_counter() - t0))
        launches.append(P.KERNEL_SINGLE.launches - n0)
        if it % 40 == 0:
            print(f"iter {it:3d}  ball landing distance {-lv:6.2f} m  ({times[-1]:.1f} ms)", flush=True)
        if time.perf_counter() - t_start > args.max_seconds:
            break
    ran = it + 1
    with torch.no_grad():
        x_final = float(landing_x(roll(us.detach())))
    ok = x_final > x_hold + 5.0
    print(f"landing distance: {x_hold:.2f} m (hold) -> {x_final:.2f} m (optimized), {ran} of "
          f"{args.iters} iterations")
    print("SUCCESS" if ok else "NOT REACHED", f": {x_final - x_hold:.2f} m beyond the hold "
          f"(success at > 5 m)")
    out = dict(script="torch_catapult_shooting", device=args.device,
               gpu=torch.cuda.get_device_name(0) if args.device == "cuda" else None,
               iters_ran=ran, iters=args.iters, x_hold=x_hold, x_final=x_final, success=ok,
               ms_per_iter_median=statistics.median(times), wall_s=time.perf_counter() - t_start,
               sweep_launches_per_iter=statistics.median(launches))
    print(json.dumps(out))
    if ran == args.iters and not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
