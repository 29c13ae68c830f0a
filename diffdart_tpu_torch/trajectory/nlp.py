"""A host NLP driver for multiple-shooting trajectory problems: hard
bounds and exact defect equality constraints, solved by scipy's SLSQP.

Counterpart of diffdart_tpu/trajectory/nlp.py. The objective's value and
gradient come from autograd through the segment rollouts; the defect
Jacobian is block-bidiagonal (d defect_k / d knot_j is nonzero only for
j in {k-1, k} and the k-th control segment) and is taken segment-wise:
the K-1 segments roll as one batch, and nx backward passes (the unit
cotangent e_i on every segment's end state) give every segment's block at
once. The blocks are scattered into the dense float64 matrix SLSQP takes.

The decision vector is z = [us.ravel() | knots.ravel()], the knots being
the interior segment-start states.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from diffdart_tpu_torch.trajectory.shooting import MultipleShooting, ShootingResult, _rollout


class NLPInfo(NamedTuple):
    status: int
    message: str
    n_iter: int
    constraint_violation: float


def _defect_jacobian_fns(ms: MultipleShooting, x0, dtype):
    """(con_val, con_jac) of the defect equality constraints. con_val:
    z -> raveled defects ((K-1) nx,) as a tensor. con_jac: z (numpy) ->
    the dense float64 Jacobian, from the segment-wise blocks."""
    T, K, S, nx, nu = ms.T, ms.K, ms.S, ms.nx, ms.nu
    n_u = T * nu
    n_k = (K - 1) * nx
    dev = x0.device

    def unpack(z):
        return z[n_u:].reshape(K - 1, nx), z[:n_u].reshape(T, nu)

    def con_val(z):
        knots, us = unpack(torch.as_tensor(z, dtype=dtype, device=dev))
        with torch.no_grad():
            _, defects, _ = ms._eval(knots, us, x0)
        return defects.reshape(-1)

    def seg_jac_blocks(z):
        """jx (K-1, nx, nx) d end_k / d start_k, ju (K-1, nx, S nu)
        d end_k / d u_seg_k."""
        knots, us = unpack(torch.as_tensor(z, dtype=dtype, device=dev))
        starts = torch.cat([x0[None], knots], dim=0)[: K - 1].clone().requires_grad_(True)
        us_seg = us.reshape(K, S, nu)[: K - 1].clone().requires_grad_(True)
        t0s = torch.arange(K - 1, device=dev) * S
        with torch.enable_grad():
            ends = ms._segment_ends(starts, us_seg, t0s)
            rows_x, rows_u = [], []
            for i in range(nx):
                e = torch.zeros_like(ends)
                e[:, i] = 1.0
                gx, gu = torch.autograd.grad(ends, (starts, us_seg), e, retain_graph=i + 1 < nx,
                                             allow_unused=True)
                rows_x.append(torch.zeros_like(starts) if gx is None else gx)
                rows_u.append(torch.zeros_like(us_seg) if gu is None else gu)
        jx = torch.stack(rows_x, dim=1)
        ju = torch.stack(rows_u, dim=1).reshape(K - 1, nx, S * nu)
        return jx, ju

    def con_jac(z):
        jx, ju = (x.detach().cpu().double().numpy() for x in seg_jac_blocks(z))
        J = np.zeros((n_k, n_u + n_k))
        eye = np.eye(nx)
        for k in range(K - 1):
            r = slice(k * nx, (k + 1) * nx)
            J[r, k * S * nu:(k + 1) * S * nu] = ju[k]
            if k >= 1:  # jx[0] differentiates with respect to the constant x0
                J[r, n_u + (k - 1) * nx:n_u + k * nx] = jx[k]
            J[r, n_u + k * nx:n_u + (k + 1) * nx] = -eye
        return J

    return con_val, con_jac


def solve_slsqp(
    ms: MultipleShooting,
    x0,
    us_init,
    u_lo=None,
    u_hi=None,
    x_lo=None,
    x_hi=None,
    max_iter: int = 100,
    tol: float = 1e-8,
    intermediate_callback=None,
    diagnose_model=None,
    diagnose_control_map=None,
):
    """Solve the multiple-shooting problem as a host NLP.

    u_lo/u_hi: scalar or (nu,) hard control bounds (every step); x_lo/x_hi:
    scalar or (nx,) hard bounds on the knot states; None is free.
    intermediate_callback(iteration, xs, us, cost): once per major SQP
    iteration, with the current single-shooting rollout. diagnose_model:
    the Model behind ms.f; the LCP's residual is then checked along the
    solution (trajectory/stall.py).

    Returns (ShootingResult, NLPInfo); the defects at the solution meet
    the SQP's equality tolerance (NLPInfo.constraint_violation)."""
    from scipy.optimize import minimize

    T, K, S, nx, nu = ms.T, ms.K, ms.S, ms.nx, ms.nu
    n_u = T * nu
    n_k = (K - 1) * nx
    dtype, dev = x0.dtype, x0.device
    x0 = x0.detach()

    def unpack(z):
        return z[n_u:].reshape(K - 1, nx), z[:n_u].reshape(T, nu)

    def f_and_g(z):
        zt = torch.tensor(z, dtype=dtype, device=dev, requires_grad=True)
        with torch.enable_grad():
            knots, us = unpack(zt)
            total, _, _ = ms._eval(knots, us, x0)
            (g,) = torch.autograd.grad(total, zt)
        return total.item(), g.detach().cpu().double().numpy()

    con_val, con_jac = _defect_jacobian_fns(ms, x0, dtype)

    us_init = torch.as_tensor(us_init, dtype=dtype, device=dev)
    with torch.no_grad():
        xs_init, _ = _rollout(ms.f, x0, us_init, ms.rc, ms.tc)
    knots0 = xs_init[S::S][: K - 1]
    z0 = np.concatenate([us_init.cpu().double().numpy().ravel(),
                         knots0.cpu().double().numpy().ravel()])

    def tile_bound(b, n_per, count, default):
        if b is None:
            return np.full(n_per * count, default)
        return np.tile(np.broadcast_to(np.asarray(b, np.float64), (n_per,)), count)

    lo = np.concatenate([tile_bound(u_lo, nu, T, -np.inf), tile_bound(x_lo, nx, K - 1, -np.inf)])
    hi = np.concatenate([tile_bound(u_hi, nu, T, np.inf), tile_bound(x_hi, nx, K - 1, np.inf)])

    it_count = [0]

    def cb(z):
        it_count[0] += 1
        if intermediate_callback is not None:
            us = torch.tensor(z[:n_u].reshape(T, nu), dtype=dtype, device=dev)
            with torch.no_grad():
                xs_it, cost_it = _rollout(ms.f, x0, us, ms.rc, ms.tc)
            intermediate_callback(it_count[0], xs_it, us, cost_it)

    constraints = []
    if n_k:
        constraints.append(dict(
            type="eq", fun=lambda z: con_val(z).cpu().double().numpy(), jac=con_jac))
    res = minimize(f_and_g, z0, jac=True, bounds=list(zip(lo, hi)), constraints=constraints,
                   method="SLSQP", tol=tol, callback=cb, options=dict(maxiter=max_iter))

    us = torch.tensor(res.x[:n_u].reshape(T, nu), dtype=dtype, device=dev)
    with torch.no_grad():
        xs, cost = _rollout(ms.f, x0, us, ms.rc, ms.tc)
    if diagnose_model is not None:
        from diffdart_tpu_torch.trajectory.stall import check_trajectory_stall

        check_trajectory_stall(diagnose_model, xs, us, diagnose_control_map, context="SLSQP NLP")
    viol = float(con_val(res.x).abs().max()) if n_k else 0.0
    result = ShootingResult(us=us, xs=xs, cost=cost,
                            cost_trace=torch.tensor([res.fun], dtype=dtype, device=dev),
                            defect_norm=torch.tensor(viol, dtype=dtype, device=dev))
    info = NLPInfo(status=int(res.status), message=str(res.message), n_iter=int(res.nit),
                   constraint_violation=viol)
    return result, info
