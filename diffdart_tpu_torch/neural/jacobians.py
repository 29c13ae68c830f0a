"""Timestep Jacobians and reverse-mode backprop through one step of the vmap
stack, batch-first.

Counterpart of diffdart_tpu/neural/jacobians.py (the reference's
BackpropSnapshot: getPosPosJacobian ... getMassVelJacobian, backprop with a
LossGradient, and the WithRespectTo parameters). Every function takes a
batched State (q (B, nq), v (B, nv)) and tau (B, nv) and returns one
matrix per env: a TimestepJacobians' fields are (B, nv, nv), and mass_vel
(B, nbody, nv).

The envs are independent, so row i of every env's Jacobian comes from one
torch.autograd.grad with the unit cotangent e_i in every env; n such calls
over one retained graph give n rows. The LCP enters through its IFT
backward (ops/lcp_lowrank.py, ops/lcp.py), so a call runs one forward
solve and no sweeps in its backward passes. Model parameters (mass, com,
inertia) are expanded to one copy per env for their per-env Jacobians.

Position Jacobians are in tangent coordinates (nv x nv): a perturbation dq
of q is applied by integrate_positions(q, dq, 1), and the output is pulled
back with position_difference around the unperturbed step's q. The step
factors as q_{t+1} = integrate(q_t (+) dq, v_{t+1}), so every position
output's Jacobian is P_q (d dq / d x) + P_v (d v_{t+1} / d x), where P_q
and P_v are tangent maps of the integration alone: reverse rows run only
for the nv velocity outputs, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from diffdart_tpu_torch.dynamics import dynamics as D
from diffdart_tpu_torch.dynamics.model import Model, State
from diffdart_tpu_torch.sim.step import step


class TimestepJacobians(NamedTuple):
    pos_pos: torch.Tensor  # (B, nv, nv) d q_{t+1} / d q_t (tangent coordinates)
    pos_vel: torch.Tensor  # (B, nv, nv) d v_{t+1} / d q_t
    vel_pos: torch.Tensor  # (B, nv, nv) d q_{t+1} / d v_t
    vel_vel: torch.Tensor  # (B, nv, nv) d v_{t+1} / d v_t
    force_pos: torch.Tensor  # (B, nv, nv) d q_{t+1} / d tau_t
    force_vel: torch.Tensor  # (B, nv, nv) d v_{t+1} / d tau_t
    mass_vel: torch.Tensor  # (B, nbody, nv) d v_{t+1} / d mass


class LossGradient(NamedTuple):
    """dL/d(q, v, tau) of one env batch, each (B, nv); wrt_position in
    tangent coordinates."""

    wrt_position: torch.Tensor
    wrt_velocity: torch.Tensor
    wrt_torque: torch.Tensor


def _rows(outs, leaves):
    """Per env, d outs / d leaves row by row: outs a list of (B, n_k)
    tensors, leaves (B, ...) tensors; returns, per leaf, the rows of every
    output stacked, (B, sum n_k, ...)."""
    rows = [[] for _ in leaves]
    for out in outs:
        for i in range(out.shape[-1]):
            e = torch.zeros_like(out)
            e[..., i] = 1.0
            gs = torch.autograd.grad(out, leaves, e, retain_graph=True, allow_unused=True)
            for r, g, x in zip(rows, gs, leaves):
                r.append(torch.zeros_like(x) if g is None else g)
    return [torch.stack(r, dim=1) for r in rows]


def _leaf(x):
    return x.detach().clone().requires_grad_(True)


def _per_env(model: Model, name: str, B: int):
    """A per-env copy (B, ...) of model tensor `name`, requiring grad."""
    x = getattr(model, name).detach()
    return _leaf(x.expand(B, *x.shape))


def _unit(like):
    return torch.ones((), dtype=like.dtype, device=like.device)


def _perturbed_step(model: Model, q, dq, v, tau):
    """The step from q (+) dq (from q itself if dq is None): (q_{t+1},
    v_{t+1})."""
    if dq is not None:
        q = D.integrate_positions(model, q, dq, _unit(q))
    s = step(model, State(q=q, v=v), tau)
    return s.q, s.v


def timestep_jacobians(model: Model, state: State, tau=None) -> TimestepJacobians:
    """All timestep Jacobians at (q, v, tau), per env (see the module
    docstring): nv reverse rows through the step for (dq, v, tau, mass),
    and 2 nv through the integration alone for P_q and P_v."""
    q, v = state.q.detach(), state.v.detach()
    tau = torch.zeros_like(v) if tau is None else tau.detach()
    B = q.shape[0]
    with torch.enable_grad():
        dq, v_, tau_, mass = _leaf(torch.zeros_like(v)), _leaf(v), _leaf(tau), _per_env(model, "mass", B)
        q_new, v_new = _perturbed_step(model.replace(mass=mass), q, dq, v_, tau_)
        vel_q, vel_v, vel_tau, vel_mass = _rows([v_new], [dq, v_, tau_, mass])
        # the position half of the step as a function of (dq, v_{t+1}),
        # pulled back around the unperturbed output
        dq1, vn = _leaf(torch.zeros_like(v)), _leaf(v_new)
        q1 = D.integrate_positions(model, q, dq1, _unit(q))
        d = D.position_difference(model, q_new.detach(),
                                  D.integrate_positions(model, q1, vn, model.dt.to(q.dtype)))
        P_q, P_v = _rows([d], [dq1, vn])
    return TimestepJacobians(
        pos_pos=P_q + P_v @ vel_q,
        pos_vel=vel_q,
        vel_pos=P_v @ vel_v,
        vel_vel=vel_v,
        force_pos=P_v @ vel_tau,
        force_vel=vel_tau,
        mass_vel=vel_mass.transpose(-1, -2),
    )


def backprop(model: Model, state: State, tau, next_grad: LossGradient) -> LossGradient:
    """One reverse step: (dL/dq', dL/dv') -> (dL/dq, dL/dv, dL/dtau) per env
    with a single backward pass (no Jacobian is formed)."""
    q, v = state.q.detach(), state.v.detach()
    with torch.enable_grad():
        dq, v_, tau_ = _leaf(torch.zeros_like(v)), _leaf(v), _leaf(tau)
        q_new, v_new = _perturbed_step(model, q, dq, v_, tau_)
        pos = D.position_difference(model, q_new.detach(), q_new)
        gq, gv, gt = torch.autograd.grad((pos, v_new), (dq, v_, tau_),
                                         (next_grad.wrt_position, next_grad.wrt_velocity))
    return LossGradient(wrt_position=gq, wrt_velocity=gv, wrt_torque=gt)


_PARAMS = {"group_masses": "mass", "group_coms": "com", "group_inertias": "inertia"}


def jacobian_wrt(model: Model, state: State, tau, wrt: str):
    """(d q_{t+1} / d x, d v_{t+1} / d x) per env, q_{t+1} in tangent
    coordinates, for wrt in {'position', 'velocity', 'force',
    'group_masses', 'group_coms', 'group_inertias'}: each (B, nv, *x's
    per-env shape), e.g. (B, nv, nbody, 3) for 'group_coms'."""
    q, v, tau = state.q.detach(), state.v.detach(), tau.detach()
    B = q.shape[0]
    with torch.enable_grad():
        dq = None
        if wrt == "position":
            x = dq = _leaf(torch.zeros_like(v))
        elif wrt == "velocity":
            x = v = _leaf(v)
        elif wrt == "force":
            x = tau = _leaf(tau)
        elif wrt in _PARAMS:
            x = _per_env(model, _PARAMS[wrt], B)
            model = model.replace(**{_PARAMS[wrt]: x})
        else:
            raise ValueError(f"unknown wrt: {wrt}")
        q_new, v_new = _perturbed_step(model, q, dq, v, tau)
        (jac,) = _rows([D.position_difference(model, q_new.detach(), q_new), v_new], [x])
    nv = v.shape[-1]
    return jac[:, :nv], jac[:, nv:]
