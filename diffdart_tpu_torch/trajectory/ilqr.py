"""iLQR over the differentiable step of the vmap stack.

Counterpart of diffdart_tpu/trajectory/ilqr.py, batch-first. The state is
the flat (q, v) vector. The dynamics `f(x, u)` take a batch, x (B, nx) and
u (B, nu), and return x' (B, nx) (a single (nx,) state works too); the
costs are the user's per-env functions, running_cost(x, u, t) and
terminal_cost(x), written in torch ops so that torch.func can vmap and
differentiate them.

Each iteration runs:
  * the linearization: one batched step of B = T envs (every nominal
    (x_t, u_t) an env), then one backward pass per output row with the
    unit cotangent e_i in every env (as neural/jacobians.py does): the T
    Jacobians fx, fu without a loop over time. The LCP's autograd
    Functions have no vmap rule, so torch.func.jacrev cannot take the step;
  * the cost derivatives (lx, lu, lxx, luu, lux, the terminal gradient and
    Hessian) with torch.func on the plain cost functions, vmapped over t;
  * the Riccati sweep, the regularisation schedule and the acceptance rule
    of the JAX package;
  * the line search: one rollout with B = len(alphas), one env per step
    size.

For models with quaternion dofs (FREE/BALL joints) pass
`charts=tangent_ops(model)`: linearization, the Riccati sweep and the
feedback law then run in the 2 nv-dimensional tangent space.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from diffdart_tpu_torch.dynamics.model import Model, State
from diffdart_tpu_torch.sim.step import step


class ILQRResult(NamedTuple):
    us: torch.Tensor  # (T, nu) optimized controls
    xs: torch.Tensor  # (T+1, nx) optimized state trajectory
    cost: torch.Tensor  # () final cost
    cost_trace: torch.Tensor  # (iters,) cost after each iteration


def tangent_ops(model: Model):
    """(retract, local_diff, tangent_dim) charts for a model whose
    configuration has quaternion (FREE/BALL) joints, on (..., nx) states:
    retract(x, e) = x (+) e with e = (dq, dv) in R^(2 nv) (geometric
    position integration), local_diff(a, b) = b (-) a. For scalar-joint
    models both reduce exactly to + and -."""
    from diffdart_tpu_torch.dynamics.dynamics import integrate_positions, position_difference

    nq, nv = model.nq, model.nv

    def retract(x, e):
        q = integrate_positions(model, x[..., :nq], e[..., :nv], 1.0)
        return torch.cat([q, x[..., nq:] + e[..., nv:]], dim=-1)

    def local_diff(a, b):
        dq = position_difference(model, a[..., :nq], b[..., :nq])
        return torch.cat([dq, b[..., nq:] - a[..., nq:]], dim=-1)

    return retract, local_diff, 2 * nv


def make_dynamics(model: Model, control_map=None) -> Callable:
    """x' = f(x, u) on flat states, x (B, nx) and u (B, nu) (or one (nx,)
    state). control_map lifts (..., nu) controls to (..., nv) generalised
    forces (an actuated-dof selector, say)."""
    nq = model.nq

    def f(x, u):
        xb, ub = x.reshape(-1, x.shape[-1]), u.reshape(-1, u.shape[-1])
        tau = ub if control_map is None else control_map(ub)
        s = step(model, State(q=xb[:, :nq], v=xb[:, nq:]), tau)
        return torch.cat([s.q, s.v], dim=-1).reshape(x.shape)

    return f


def _costs(running_cost, x, u, t):
    """running_cost per env of a batch: x (B, nx), u (B, nu), t (B,) int64."""
    return torch.func.vmap(running_cost)(x, u, t)


def _terminal(terminal_cost, x):
    return torch.func.vmap(terminal_cost)(x)


def _linearize(f, retract, local_diff, xs, us, nt):
    """fx (T, nt, nt), fu (T, nt, nu): the Jacobians of
    e, du -> local_diff(x_{t+1}, f(x_t (+) e, u_t + du)) at zero, from one
    batched step of the T nominal points and nt backward passes."""
    T, nu = us.shape
    E = torch.zeros(T, nt, dtype=xs.dtype, device=xs.device, requires_grad=True)
    DU = torch.zeros(T, nu, dtype=xs.dtype, device=xs.device, requires_grad=True)
    with torch.enable_grad():
        Y = local_diff(xs[1:], f(retract(xs[:-1], E), us + DU))
        rows_x, rows_u = [], []
        for i in range(Y.shape[-1]):
            e = torch.zeros_like(Y)
            e[:, i] = 1.0
            gx, gu = torch.autograd.grad(Y, (E, DU), e, retain_graph=i + 1 < Y.shape[-1],
                                         allow_unused=True)
            rows_x.append(torch.zeros_like(E) if gx is None else gx)
            rows_u.append(torch.zeros_like(DU) if gu is None else gu)
    return torch.stack(rows_x, dim=1).detach(), torch.stack(rows_u, dim=1).detach()


def ilqr(
    f: Callable,
    running_cost: Callable,
    terminal_cost: Callable,
    x0: torch.Tensor,
    us_init: torch.Tensor,
    iters: int = 50,
    reg_init: float = 1e-6,
    alphas=(1.0, 0.6, 0.3, 0.1, 0.03, 0.01),
    diagnose_model: Model | None = None,
    diagnose_control_map: Callable | None = None,
    charts=None,
) -> ILQRResult:
    """Iterative LQR. f(x, u) -> x' on a batch; running_cost(x, u, t) ->
    scalar and terminal_cost(x) -> scalar per env. x0 (nx,), us_init
    (T, nu).

    charts: optional (retract, local_diff, tangent_dim), e.g.
    `tangent_ops(model)`; None is Euclidean (classical iLQR, exact for
    scalar-joint models). diagnose_model: the Model behind `f`; the
    contact solver's health is then checked along the optimized trajectory
    and a SolverStallWarning fires if the LCP stalled anywhere
    (trajectory/stall.py). diagnose_control_map: the control lift given to
    make_dynamics."""
    T, nu = us_init.shape
    nx = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    x0 = x0.detach()
    us_init = us_init.detach().to(dtype)
    alphas_t = torch.tensor(alphas, dtype=dtype, device=dev)
    A = alphas_t.shape[0]
    if charts is None:
        def retract(x, e):
            return x + e

        def local_diff(a, b):
            return b - a

        nt = nx
    else:
        retract, local_diff, nt = charts
    e0 = torch.zeros(nt, dtype=dtype, device=dev)
    zu = torch.zeros(nu, dtype=dtype, device=dev)
    ts = torch.arange(T, device=dev)

    def rollout_cost(us):
        x = x0[None]
        xs, total = [x0], torch.zeros(1, dtype=dtype, device=dev)
        for t in range(T):
            u = us[t][None]
            total = total + _costs(running_cost, x, u, ts[t:t + 1])
            x = f(x, u)
            xs.append(x[0])
        return torch.stack(xs), (total + _terminal(terminal_cost, x))[0]

    def c_run(e, du, xb, ub, t):
        return running_cost(retract(xb, e), ub + du, t)

    def c_term(e, xb):
        return terminal_cost(retract(xb, e))

    def run_derivs(xs, us):
        g = torch.func
        args = (e0.expand(T, nt), zu.expand(T, nu), xs[:-1], us, ts)
        lx = g.vmap(g.grad(c_run, argnums=0))(*args)
        lu = g.vmap(g.grad(c_run, argnums=1))(*args)
        lxx = g.vmap(g.hessian(c_run, argnums=0))(*args)
        luu = g.vmap(g.hessian(c_run, argnums=1))(*args)
        lux = g.vmap(g.jacrev(g.grad(c_run, argnums=1), argnums=0))(*args)
        return lx, lu, lxx, luu, lux

    eye_u = torch.eye(nu, dtype=dtype, device=dev)

    def backward(xs, us, reg):
        fx, fu = _linearize(f, retract, local_diff, xs, us, nt)
        with torch.no_grad():
            lx, lu, lxx, luu, lux = run_derivs(xs, us)
            Vx = torch.func.grad(c_term)(e0, xs[-1])
            Vxx = torch.func.hessian(c_term)(e0, xs[-1])
            ok = True
            ks, Ks = [None] * T, [None] * T
            for t in reversed(range(T)):
                fx_t, fu_t = fx[t], fu[t]
                Qx = lx[t] + fx_t.T @ Vx
                Qu = lu[t] + fu_t.T @ Vx
                Qxx = lxx[t] + fx_t.T @ Vxx @ fx_t
                Quu = luu[t] + fu_t.T @ Vxx @ fu_t + reg * eye_u
                Qux = lux[t] + fu_t.T @ Vxx @ fx_t
                L, info = torch.linalg.cholesky_ex(Quu)
                if int(info) != 0 or not bool(torch.isfinite(L).all()):
                    ok = False  # the step is rejected; the JAX sweep runs on in NaN
                    break
                k = -torch.cholesky_solve(Qu[:, None], L)[:, 0]
                K = -torch.cholesky_solve(Qux, L)
                Vx = Qx + K.T @ Quu @ k + K.T @ Qu + Qux.T @ k
                Vxx = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
                Vxx = 0.5 * (Vxx + Vxx.T)
                ks[t], Ks[t] = k, K
        return ks, Ks, ok

    def forward(xs, us, ks, Ks):
        """The line search: every step size an env of one rollout."""
        x = x0.expand(A, nx)
        xs_n, us_n = [x], []
        total = torch.zeros(A, dtype=dtype, device=dev)
        for t in range(T):
            dx = local_diff(xs[t].expand(A, nx), x)
            u = us[t] + alphas_t[:, None] * ks[t] + dx @ Ks[t].T
            total = total + _costs(running_cost, x, u, ts[t].expand(A))
            x = f(x, u)
            xs_n.append(x)
            us_n.append(u)
        total = total + _terminal(terminal_cost, x)
        return torch.stack(xs_n, dim=1), torch.stack(us_n, dim=1), total

    with torch.no_grad():
        xs, cost = rollout_cost(us_init)
    us = us_init
    reg = torch.tensor(reg_init, dtype=dtype, device=dev)
    trace = []
    for _ in range(iters):
        ks, Ks, ok = backward(xs, us, reg)
        improved = False
        if ok:
            with torch.no_grad():
                xs_c, us_c, costs_c = forward(xs, us, ks, Ks)
            best = int(torch.argmin(torch.where(torch.isfinite(costs_c), costs_c,
                                                torch.full_like(costs_c, float("inf")))))
            improved = bool(costs_c[best] < cost)
        if improved:
            xs, us, cost = xs_c[best], us_c[best], costs_c[best]
            reg = torch.clamp(reg * 0.5, min=1e-9)
        else:
            reg = torch.clamp(reg * 10.0, max=1e6)
        trace.append(cost)
    if diagnose_model is not None:
        from diffdart_tpu_torch.trajectory.stall import check_trajectory_stall

        check_trajectory_stall(diagnose_model, xs, us, diagnose_control_map, context="ilqr")
    cost_trace = torch.stack(trace) if trace else torch.zeros(0, dtype=dtype, device=dev)
    return ILQRResult(us=us, xs=xs, cost=cost, cost_trace=cost_trace)
