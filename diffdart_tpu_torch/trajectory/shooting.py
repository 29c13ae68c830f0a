"""Single and multiple shooting trajectory optimization.

Counterpart of diffdart_tpu/trajectory/shooting.py, batch-first. The
dynamics `f(x, u)` take a batch (trajectory/ilqr.py::make_dynamics), the
costs are per-env functions vmapped with torch.func. The loss and its
gradient come from autograd through the rollout, each step checkpointed
(recomputed in the backward pass, as jax.checkpoint does). The JAX package
takes an optax rule; here `optimizer` builds a torch.optim optimizer over
the decision tensors, by default torch.optim.Adam at optax.adam's learning
rates (1e-1 single, 5e-2 multiple shooting): its updates equal optax.adam's
in float64 to rounding. Multiple shooting runs its segments as one batch
of K envs, and drives the defects to zero with an augmented Lagrangian.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from diffdart_tpu_torch.trajectory.ilqr import _costs, _terminal


class ShootingResult(NamedTuple):
    us: torch.Tensor  # (T, nu)
    xs: torch.Tensor  # (T+1, nx) rollout under us
    cost: torch.Tensor
    cost_trace: torch.Tensor
    defect_norm: torch.Tensor  # final multiple-shooting defect (0 for single)


def _adam(lr: float):
    return lambda params: torch.optim.Adam(params, lr=lr)


def _segments(f, starts, us_seg, t0s, running_cost, remat=False):
    """Roll K segments as one batch: starts (K, nx), us_seg (K, S, nu),
    t0s (K,) their first time indices. Returns (ends (K, nx), costs (K,),
    xs (K, S+1, nx))."""
    x = starts
    xs = [x]
    total = torch.zeros(starts.shape[0], dtype=starts.dtype, device=starts.device)
    for s in range(us_seg.shape[1]):
        u = us_seg[:, s]
        total = total + _costs(running_cost, x, u, t0s + s)
        x = checkpoint(f, x, u, use_reentrant=False) if remat else f(x, u)
        xs.append(x)
    return x, total, torch.stack(xs, dim=1)


def _rollout(f, x0, us, running_cost, terminal_cost, remat=False):
    """(xs (T+1, nx), cost) of the single rollout from x0 under us."""
    t0 = torch.zeros(1, dtype=torch.long, device=x0.device)
    xT, c, xs = _segments(f, x0[None], us[None], t0, running_cost, remat)
    return xs[0], c[0] + _terminal(terminal_cost, xT)[0]


def single_shooting(
    f: Callable,
    running_cost: Callable,
    terminal_cost: Callable,
    x0: torch.Tensor,
    us_init: torch.Tensor,
    iters: int = 200,
    optimizer=None,
    remat: bool = True,
) -> ShootingResult:
    """First-order shooting: `iters` steps of `optimizer(params)` (a
    torch.optim optimizer; Adam at 1e-1 by default) on the rollout's cost."""
    us = us_init.detach().clone().requires_grad_(True)
    opt = (optimizer or _adam(1e-1))([us])
    trace = []
    for _ in range(iters):
        opt.zero_grad()
        with torch.enable_grad():
            _, c = _rollout(f, x0, us, running_cost, terminal_cost, remat)
            c.backward()
        opt.step()
        trace.append(c.detach())
    with torch.no_grad():
        xs, cost = _rollout(f, x0, us, running_cost, terminal_cost)
    return ShootingResult(us=us.detach(), xs=xs, cost=cost, cost_trace=torch.stack(trace),
                          defect_norm=torch.zeros((), dtype=x0.dtype, device=x0.device))


class MultipleShooting:
    """Knot-point shooting: the decision variables are the control tape and
    the state at every interior segment start; the K segments roll as one
    batch; the defects knot[k+1] - end[k] are driven to zero by an
    augmented Lagrangian."""

    def __init__(self, f, running_cost, terminal_cost, T, segment_len, nx, nu):
        assert T % segment_len == 0, "horizon must divide into segments"
        self.f = f
        self.rc = running_cost
        self.tc = terminal_cost
        self.T = T
        self.K = T // segment_len
        self.S = segment_len
        self.nx = nx
        self.nu = nu

    def _eval(self, knots, us, x0):
        """knots (K-1, nx) interior knot states. Returns (total cost,
        defects (K-1, nx), segment ends (K, nx))."""
        starts = torch.cat([x0[None], knots], dim=0)
        us_seg = us.reshape(self.K, self.S, self.nu)
        t0s = torch.arange(self.K, device=x0.device) * self.S
        ends, costs, _ = _segments(self.f, starts, us_seg, t0s, self.rc)
        defects = ends[:-1] - knots
        total = costs.sum() + _terminal(self.tc, ends[-1:])[0]
        return total, defects, ends

    def _segment_ends(self, starts, us_seg, t0s):
        return _segments(self.f, starts, us_seg, t0s, self.rc)[0]

    def solve(
        self,
        x0,
        us_init,
        outer_iters: int = 8,
        inner_iters: int = 100,
        rho0: float = 10.0,
        rho_growth: float = 4.0,
        optimizer=None,
        intermediate_callback=None,
        diagnose_model=None,
        diagnose_control_map=None,
    ) -> ShootingResult:
        """intermediate_callback(iteration, xs, us, cost): called after every
        outer iteration with the current rollout. diagnose_model: the Model
        behind `f`; the LCP's residual is then checked along the final
        trajectory (trajectory/stall.py). optimizer(params): a torch.optim
        optimizer, new for each outer iteration (Adam at 5e-2 by default)."""
        make_opt = optimizer or _adam(5e-2)
        x0 = x0.detach()
        with torch.no_grad():
            xs_init, _ = _rollout(self.f, x0, us_init, self.rc, self.tc)
        knots = xs_init[self.S::self.S][: self.K - 1].clone()
        us = us_init.detach().clone()
        lam = torch.zeros(self.K - 1, self.nx, dtype=x0.dtype, device=x0.device)
        rho = torch.tensor(rho0, dtype=x0.dtype, device=x0.device)
        traces = []
        for it in range(outer_iters):
            params = [knots.requires_grad_(True), us.requires_grad_(True)]
            opt = make_opt(params)
            for _ in range(inner_iters):
                opt.zero_grad()
                with torch.enable_grad():
                    total, defects, _ = self._eval(knots, us, x0)
                    c = total + (lam * defects).sum() + 0.5 * rho * (defects**2).sum()
                    c.backward()
                opt.step()
                traces.append(c.detach())
            knots, us = knots.detach(), us.detach()
            with torch.no_grad():
                _, defects, _ = self._eval(knots, us, x0)
            lam = lam + rho * defects
            rho = rho * rho_growth
            if intermediate_callback is not None:
                with torch.no_grad():
                    xs_it, cost_it = _rollout(self.f, x0, us, self.rc, self.tc)
                intermediate_callback(it, xs_it, us, cost_it)
        with torch.no_grad():
            xs, cost = _rollout(self.f, x0, us, self.rc, self.tc)
        if diagnose_model is not None:
            from diffdart_tpu_torch.trajectory.stall import check_trajectory_stall

            check_trajectory_stall(diagnose_model, xs, us, diagnose_control_map,
                                   context="multiple shooting")
        return ShootingResult(us=us, xs=xs, cost=cost, cost_trace=torch.stack(traces),
                              defect_norm=torch.linalg.norm(defects))
