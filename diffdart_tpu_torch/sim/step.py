"""The timestep of the vmap stack, `step(model, state, tau) -> state`, and
its rollouts, batch-first.

Counterpart of diffdart_tpu/sim/step.py: semi-implicit Euler (forces ->
unconstrained velocity -> contact and joint-limit impulses from the boxed
LCP -> position integration). A state holds q (B, nq), v (B, nv) and
optionally t (B,); taus are (T, B, nv). The JAX package writes one env and
vmaps it; here every per-env tensor carries the batch axis.

Rollouts: `rollout` keeps the trajectory, `rollout_final` only the final
state (autograd stores every step's graph), `rollout_checkpointed`
recomputes each step in the backward pass (torch.utils.checkpoint per
step; the JAX package saves the LCP impulse by name and re-runs everything
else, while this version re-runs the LCP solve too: ROADMAP Queue 1 item
4b), and `rollout_segmented` recomputes segment by segment.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from diffdart_tpu_torch.dynamics import dynamics as D
from diffdart_tpu_torch.dynamics.model import Model, State
from diffdart_tpu_torch.ops.smalllinalg import spd_solve_small


def step_unconstrained(model: Model, state: State, tau=None) -> State:
    """Contact-free semi-implicit Euler step."""
    q, v = state.q, state.v
    if tau is None:
        tau = torch.zeros_like(v)
    dt = model.dt.to(q.dtype)
    cache = D.kinematics_cache(model, q, v)
    M = D.mass_matrix(model, q, cache)
    C = D.bias_forces(model, q, v, cache)
    extra_diag, f_joint = D.implicit_joint_terms(model, q, v, dt)
    M_eff = M + torch.diag_embed(extra_diag.expand_as(v))
    qdd = spd_solve_small(M_eff, tau + f_joint - C)
    v_new = v + dt * qdd
    q_new = D.integrate_positions(model, q, v_new, dt)
    t = state.t + dt if state.t is not None else None
    return State(q=q_new, v=v_new, t=t)


def step(model: Model, state: State, tau=None) -> State:
    """Full timestep with contacts and joint rows (the unconstrained step
    when the model has no collision pairs, limits or actuation rows)."""
    has_limits = model.enable_joint_limits and model.has_joint_limits
    has_actuation_rows = bool(model.servo_dofs) or bool(model.friction_dofs)
    has_bilateral = bool(model.ball_pairs) or bool(model.weld_pairs) or bool(model.mimic_pairs)
    if not model.col_pairs and not has_limits and not has_actuation_rows and not has_bilateral:
        return step_unconstrained(model, state, tau)
    from diffdart_tpu_torch.sim.constrained import step_constrained

    return step_constrained(model, state, tau)


def rollout(model: Model, state: State, taus) -> tuple[State, State]:
    """Step over a (T, B, nv) control tape; returns (final, trajectory), the
    trajectory's fields stacked as (T, B, ...)."""
    qs, vs, ts = [], [], []
    for t in range(taus.shape[0]):
        state = step(model, state, taus[t])
        qs.append(state.q)
        vs.append(state.v)
        ts.append(state.t)
    traj = State(q=torch.stack(qs), v=torch.stack(vs),
                 t=torch.stack(ts) if state.t is not None else None)
    return state, traj


def rollout_final(model: Model, state: State, taus) -> State:
    """Plain BPTT rollout: the final state; autograd keeps every step's
    graph for the backward pass (memory linear in T)."""
    for t in range(taus.shape[0]):
        state = step(model, state, taus[t])
    return state


def _step_tensors(model, q, v, t, tau):
    s = step(model, State(q=q, v=v, t=t), tau)
    return s.q, s.v, s.t


def rollout_checkpointed(model: Model, state: State, taus) -> State:
    """BPTT rollout with per-step recomputation: only each step's input
    state is kept, and the backward pass re-runs the step (the LCP solve
    included) before differentiating it."""
    q, v, t = state.q, state.v, state.t
    for k in range(taus.shape[0]):
        q, v, t = checkpoint(_step_tensors, model, q, v, t, taus[k], use_reentrant=False,
                             preserve_rng_state=False)
    return State(q=q, v=v, t=t)


def _segment(model, q, v, t, tau_seg):
    for k in range(tau_seg.shape[0]):
        q, v, t = _step_tensors(model, q, v, t, tau_seg[k])
    return q, v, t


def rollout_segmented(model: Model, state: State, taus, segment: int = 10) -> State:
    """Segment-wise recomputation: inside a segment the steps' graphs are
    kept during its backward; across segments only the carried state is.
    The horizon must be a multiple of `segment`."""
    T = taus.shape[0]
    if T % segment:
        raise ValueError(f"horizon {T} not a multiple of segment {segment}")
    q, v, t = state.q, state.v, state.t
    for k in range(0, T, segment):
        q, v, t = checkpoint(_segment, model, q, v, t, taus[k:k + segment], use_reentrant=False,
                             preserve_rng_state=False)
    return State(q=q, v=v, t=t)
