"""Receding-horizon MPC with warm starts, a control buffer, an observation
log and a wall-clock ticker.

Counterpart of diffdart_tpu/trajectory/mpc.py. Each re-optimization is an
iLQR solve (trajectory/ilqr.py) on the model's device; the host shifts the
warm start, logs observations and serves controls between solves. States
are flat (nx,) tensors; the controls the buffer serves are numpy arrays.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from diffdart_tpu_torch.trajectory.ilqr import ilqr


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ObservationLog(NamedTuple):
    """Rolling log of (t, x) observations."""

    ts: list
    xs: list

    @staticmethod
    def create():
        return ObservationLog(ts=[], xs=[])

    def observe(self, t, x):
        self.ts.append(float(t))
        self.xs.append(_np(x))


class RealTimeControlBuffer:
    """Control tape indexed by time: serves u(t) between solves and splices
    in newly optimized tapes."""

    def __init__(self, nu: int, dt: float, horizon: int):
        self.dt = dt
        self.nu = nu
        self.t0 = 0.0
        self.us = np.zeros((horizon, nu))

    def get(self, t: float):
        i = int(np.clip((t - self.t0) / self.dt, 0, len(self.us) - 1))
        return self.us[i]

    def splice(self, t_start: float, us_new):
        self.t0 = t_start
        self.us = _np(us_new)


class MPC:
    """Receding-horizon controller over the differentiable step. f,
    running_cost and terminal_cost follow trajectory/ilqr.py; pass
    `charts=tangent_ops(model)` for models with quaternion dofs. Call
    `solve(x, t)` each control period, or `run`."""

    def __init__(self, f: Callable, running_cost: Callable, terminal_cost: Callable, horizon: int,
                 nu: int, dt: float, iters_per_solve: int = 8, charts=None):
        self.horizon = horizon
        self.nu = nu
        self.dt = dt
        self.buffer = RealTimeControlBuffer(nu, dt, horizon)
        self.log = ObservationLog.create()
        self._us_warm = None  # (horizon, nu), in the first state's dtype and device

        def _solve(x0, us_init):
            return ilqr(f, running_cost, terminal_cost, x0, us_init, iters=iters_per_solve,
                        charts=charts)

        self._solve = _solve

    def solve(self, x, t: float):
        """One re-optimization from state x (nx,) at time t, warm-started
        from the previous solution shifted by the elapsed control periods
        (the tail padded with its last control)."""
        x = torch.as_tensor(x)
        self.log.observe(t, x)
        if self._us_warm is None:
            self._us_warm = torch.zeros(self.horizon, self.nu, dtype=x.dtype, device=x.device)
        shift = max(int(round((t - self.buffer.t0) / self.dt)), 0)
        warm = torch.cat([self._us_warm[shift:],
                          self._us_warm[-1:].repeat(min(shift, self.horizon), 1)])[: self.horizon]
        res = self._solve(x, warm)
        self._us_warm = res.us
        self.buffer.splice(t, res.us)
        return res

    def get_control(self, t: float):
        return self.buffer.get(t)

    def run(self, env_step: Callable, x0, duration: float, replan_every: int = 5):
        """Closed loop: env_step(x, u) -> x advances the plant; a re-plan
        every `replan_every` control periods. Returns the (n+1, nx) states."""
        x = torch.as_tensor(x0)
        t = 0.0
        traj = [_np(x)]
        for k in range(int(duration / self.dt)):
            if k % replan_every == 0:
                self.solve(x, t)
            u = torch.as_tensor(self.get_control(t), dtype=x.dtype, device=x.device)
            with torch.no_grad():
                x = env_step(x, u)
            t += self.dt
            traj.append(_np(x))
        return np.stack(traj)


class Ticker:
    """Wall-clock ticker: calls registered listeners at a fixed period until
    stopped."""

    def __init__(self, period_s: float):
        self.period = period_s
        self._listeners = []
        self._running = False

    def registerTickListener(self, fn):
        self._listeners.append(fn)

    def start(self, max_ticks: int | None = None):
        self._running = True
        ticks = 0
        next_t = time.perf_counter()
        while self._running and (max_ticks is None or ticks < max_ticks):
            now = time.perf_counter()
            if now >= next_t:
                for fn in self._listeners:
                    fn(now)
                ticks += 1
                next_t += self.period
            else:
                time.sleep(min(next_t - now, 0.001))

    def stop(self):
        self._running = False
