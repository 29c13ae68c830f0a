"""Constrained timestep of the vmap stack: collision -> LCP -> impulse ->
integrate, batch-first.

Counterpart of diffdart_tpu/sim/constrained.py. Gradients flow through the
dynamics and the contact geometry by autograd and through the LCP solve by
the IFT, forward and reverse (ops/lcp_lowrank.py::BoxedLcpLowrank,
ops/lcp.py::BoxedLcp).

contact_solver: 'lowrank' runs the sweeps as plain PyTorch (_jacobi);
'lowrank_pallas' runs them through ops/pallas_lcp.py, which launches the
sweep kernel on CUDA tensors (and takes _jacobi only for CPU tensors; it
never quietly uses the plain version on the card); 'jacobi' and 'pgs' run
the dense boxed_lcp of ops/lcp.py (plain PyTorch, no kernel).

`step_and_impulse` also returns the LCP impulse lambda, in the solve's
dtype, and takes one back: given lambda, no solve runs and the step's
derivatives are the IFT's at it (sim/step.py::rollout_checkpointed keeps
lambda per step that way).
"""
from __future__ import annotations

import torch

from diffdart_tpu_torch.collision.collide import collide_world_with_bodies, select_contacts
from diffdart_tpu_torch.constraints.assembly import assemble_constraints
from diffdart_tpu_torch.dynamics import dynamics as D
from diffdart_tpu_torch.dynamics.model import Model, State
from diffdart_tpu_torch.ops.lcp import _jacobi, _matvec, _nat_residual, boxed_lcp
from diffdart_tpu_torch.ops.lcp_lowrank import boxed_lcp_lowrank
from diffdart_tpu_torch.ops.pallas_lcp import jacobi_sweeps_pallas_single
from diffdart_tpu_torch.ops.smalllinalg import cho_solve_small, cholesky_small


def _dt(model: Model, like):
    return model.dt.to(like.dtype)


def prepare_constrained(model: Model, state: State, tau=None):
    """Everything before the LCP solve: (lcp, M, Minv, v_star, dt), with
    per-env tensors (B, ...)."""
    q, v = state.q, state.v
    if tau is None:
        tau = torch.zeros_like(v)
    dt = _dt(model, q)
    cache = D.kinematics_cache(model, q, v)
    M_plain = D.mass_matrix(model, q, cache)
    C = D.bias_forces(model, q, v, cache)
    extra_diag, f_joint = D.implicit_joint_terms(model, q, v, dt)
    M = M_plain + torch.diag_embed(extra_diag.expand_as(v))
    L = cholesky_small(M)
    Minv = cho_solve_small(L, torch.eye(model.nv, dtype=q.dtype, device=q.device).expand_as(M))
    v_star = v + dt * _matvec(Minv, tau + f_joint - C)
    contacts, ba, bb = collide_world_with_bodies(model, cache["R"], cache["p"])
    contacts, body_a, body_b = select_contacts(model, contacts, ba, bb)
    qt = D.q_tangent(model, q)
    lcp = assemble_constraints(model, contacts, cache["Sw"], cache["mask"], Minv, v_star, v, qt, dt,
                               R_body=cache["R"], p_body=cache["p"], body_a=body_a, body_b=body_b)
    return lcp, M, Minv, v_star, dt


def solve_contact_lcp(model: Model, lcp, M, lam=None):
    """The configured LCP solve on an assembled problem: lam (B, D) in the
    state's dtype. `lam`: see _solve_lcp."""
    return _solve_lcp(model, lcp, M, lam).to(lcp.b.dtype)


def _solve_lcp(model: Model, lcp, M, lam=None):
    """lam (B, D) in the solve's dtype (float64 under lcp_dtype='f64').
    Given `lam` (an earlier result of this function on the same problem),
    no solve runs and the derivatives are the IFT's at it."""
    dtype = lcp.b.dtype
    if model.lcp_dtype == "f64" and dtype != torch.float64:
        # float64 island: promote the solve and its IFT gradient (the
        # casts are linear, so autograd composes)
        f64 = torch.float64
        lcp64 = lcp._replace(J=lcp.J.to(f64), A=lcp.A.to(f64), b=lcp.b.to(f64), lo=lcp.lo.to(f64),
                             hi=lcp.hi.to(f64), mu=lcp.mu.to(f64))
        return _solve_lcp(model.replace(lcp_dtype="state"), lcp64, M.to(f64), lam)
    if model.contact_solver in ("jacobi", "pgs"):
        return boxed_lcp(lcp.A, lcp.b, lcp.lo, lcp.hi, lcp.mu, lcp.fidx, model.contact_iters,
                         model.contact_solver, model.lcp_polish, lam)
    if model.contact_solver not in ("lowrank", "lowrank_pallas"):
        raise ValueError(f"unknown contact_solver {model.contact_solver!r}; one of 'lowrank', "
                         f"'lowrank_pallas', 'jacobi', 'pgs'")
    sweeps = jacobi_sweeps_pallas_single if model.contact_solver == "lowrank_pallas" else _jacobi
    cfm = torch.tensor(model.contact_cfm, dtype=dtype, device=lcp.b.device)
    return boxed_lcp_lowrank(lcp.J, M, cfm, lcp.b, lcp.lo, lcp.hi, lcp.mu, lcp.fidx,
                             model.contact_iters, 2 if model.lcp_polish else 0, sweeps,
                             model.lcp_pivot_iters, lam)


def solver_diagnostics(model: Model, state: State, tau=None):
    """Per-env natural-map residual (B,) of the LCP solution at this state:
    <= ~1e-6 in float64 means a pivot-accurate solve, values far above the
    precision floor (~eps/cfm; ~4e-2 in float32 at cfm = 1e-6) a stalled
    one, whose IFT gradient is unreliable."""
    lcp, M, Minv, v_star, dt = prepare_constrained(model, state, tau)
    if lcp.A.shape[-1] == 0:
        return torch.zeros(state.q.shape[:-1], dtype=state.q.dtype, device=state.q.device)
    lam = solve_contact_lcp(model, lcp, M)
    return _nat_residual(lam, lcp.A, lcp.b, lcp.lo, lcp.hi, lcp.mu, lcp.fidx)


def step_and_impulse(model: Model, state: State, tau=None, lam=None):
    """(next state, lam): lam (B, D) is the LCP impulse in the solve's dtype
    (None when the LCP has no rows). Given `lam` from an earlier call at
    the same (state, tau), no solve runs: the same step, whose derivatives
    are the IFT's at lam."""
    lcp, M, Minv, v_star, dt = prepare_constrained(model, state, tau)
    if lcp.A.shape[-1] == 0:
        v_new, lam = v_star, None
    else:
        lam = _solve_lcp(model, lcp, M, lam)
        v_new = v_star + _matvec(Minv, _matvec(lcp.J.transpose(-1, -2), lam.to(lcp.b.dtype)))
    q_new = D.integrate_positions(model, state.q, v_new, dt)
    t = state.t + dt if state.t is not None else None
    return State(q=q_new, v=v_new, t=t), lam


def step_constrained(model: Model, state: State, tau=None) -> State:
    return step_and_impulse(model, state, tau)[0]
