"""Batched-step execution path: the LCP warm-start sweeps run as one
batched call over every env.

Counterpart of diffdart_tpu/sim/batched.py. `step_batched(model, states,
taus)` computes what sim/step.py::step does with contact_solver='lowrank'
and two polish passes, split in three: per-env assembly (_pre), the sweeps
over the whole batch (ops/pallas_lcp.py::jacobi_sweeps_pallas: the sweep
kernel on CUDA tensors, _jacobi on CPU tensors), then the active-set polish
and the integration (_post). There is no pivot refinement on this path, as
in the JAX package.

Forward only, as in the JAX package: when an input requires grad, the
result is attached to the graph through a node whose backward raises.
"""
from __future__ import annotations

import torch

from diffdart_tpu_torch.collision.collide import collide_world_with_bodies
from diffdart_tpu_torch.constraints.assembly import assemble_constraints
from diffdart_tpu_torch.dynamics import dynamics as D
from diffdart_tpu_torch.dynamics.model import Model, State
from diffdart_tpu_torch.ops.lcp import _matvec
from diffdart_tpu_torch.ops.lcp_lowrank import _polish_lowrank, full_precision
from diffdart_tpu_torch.ops.pallas_lcp import jacobi_sweeps_pallas
from diffdart_tpu_torch.ops.smalllinalg import cho_solve_small, cholesky_small


def _pre(model: Model, state: State, tau):
    """Everything before the LCP solve."""
    q, v = state.q, state.v
    dt = model.dt.to(q.dtype)
    cache = D.kinematics_cache(model, q, v)
    M_plain = D.mass_matrix(model, q, cache)
    C = D.bias_forces(model, q, v, cache)
    extra_diag, f_joint = D.implicit_joint_terms(model, q, v, dt)
    M = M_plain + torch.diag_embed(extra_diag.expand_as(v))
    L = cholesky_small(M)
    Minv = cho_solve_small(L, torch.eye(model.nv, dtype=q.dtype, device=q.device).expand_as(M))
    v_star = v + dt * _matvec(Minv, tau + f_joint - C)
    contacts, ba, bb = collide_world_with_bodies(model, cache["R"], cache["p"])
    qt = D.q_tangent(model, q)
    lcp = assemble_constraints(model, contacts, cache["Sw"], cache["mask"], Minv, v_star, v, qt, dt,
                               R_body=cache["R"], p_body=cache["p"], body_a=ba, body_b=bb)
    return lcp, M, L, Minv, v_star


def _post(model: Model, state: State, lcp, L, Minv, v_star, lam):
    dtype = state.q.dtype
    dt = model.dt.to(dtype)
    cfm = torch.tensor(model.contact_cfm, dtype=dtype, device=state.q.device)
    J = lcp.J
    with full_precision():
        A = J @ cho_solve_small(L, J.transpose(-1, -2)) + cfm * torch.eye(
            J.shape[-2], dtype=dtype, device=J.device)
        lam = _polish_lowrank(lam, J, L, cfm, A, lcp.b, lcp.lo, lcp.hi, lcp.mu, lcp.fidx, passes=2)
        v_new = v_star + _matvec(Minv, _matvec(J.transpose(-1, -2), lam))
    q_new = D.integrate_positions(model, state.q, v_new, dt)
    t = state.t + dt if state.t is not None else None
    return State(q=q_new, v=v_new, t=t)


class _ForwardOnly(torch.autograd.Function):
    """Identity on the outputs; its backward raises."""

    @staticmethod
    def forward(ctx, q, v, *inputs):
        return q.clone(), v.clone()

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("step_batched is forward only (as in the JAX package); "
                           "differentiate sim/step.py::step instead")


def _step_batched(model: Model, states: State, taus):
    lcp, M, L, Minv, v_star = _pre(model, states, taus)
    dtype = states.q.dtype
    if lcp.b.shape[-1] == 0:
        dt = model.dt.to(dtype)
        q_new = D.integrate_positions(model, states.q, v_star, dt)
        return State(q=q_new, v=v_star, t=states.t + dt if states.t is not None else None)
    with full_precision():
        W = cho_solve_small(L, lcp.J.transpose(-1, -2))
        A = lcp.J @ W + model.contact_cfm * torch.eye(lcp.b.shape[-1], dtype=dtype,
                                                      device=lcp.b.device)
        lam = jacobi_sweeps_pallas(A, lcp.b, lcp.lo, lcp.hi, lcp.mu, lcp.fidx, model.contact_iters)
    return _post(model, states, lcp, L, Minv, v_star, lam)


def step_batched(model: Model, states: State, taus) -> State:
    """What vmap(step) computes (contact_solver='lowrank', two polish
    passes, no pivot refinement), with the warm-start sweeps as one call
    over the batch. states: q (B, nq), v (B, nv); taus (B, nv). Forward
    only."""
    inputs = [x for x in (states.q, states.v, taus) if x is not None]
    params = [x for x in vars(model).values() if isinstance(x, torch.Tensor)]
    tracked = torch.is_grad_enabled() and any(x.requires_grad for x in inputs + params)
    with torch.no_grad():
        out = _step_batched(model, states, taus)
    if not tracked:
        return out
    q, v = _ForwardOnly.apply(out.q, out.v, *inputs, *params)
    return State(q=q, v=v, t=out.t)
