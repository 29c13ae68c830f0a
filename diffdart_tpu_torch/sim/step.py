"""The timestep of the vmap stack, `step(model, state, tau) -> state`, and
its rollouts, batch-first.

Counterpart of diffdart_tpu/sim/step.py: semi-implicit Euler (forces ->
unconstrained velocity -> contact and joint-limit impulses from the boxed
LCP -> position integration). A state holds q (B, nq), v (B, nv) and
optionally t (B,); taus are (T, B, nv). The JAX package writes one env and
vmaps it; here every per-env tensor carries the batch axis.

Rollouts: `rollout` keeps the trajectory, `rollout_final` only the final
state (autograd stores every step's graph), `rollout_checkpointed` keeps
each step's input and LCP impulse lambda and recomputes the rest of the
step in the backward pass with that lambda (no second solve: the JAX
package saves the impulse by name, `save_only_these_names("lcp_lam")`),
and `rollout_segmented` recomputes segment by segment.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from diffdart_tpu_torch.dynamics import dynamics as D
from diffdart_tpu_torch.dynamics.model import _ARRAY_FIELDS, Model, State
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


def _is_constrained(model: Model) -> bool:
    """Whether the model's step has LCP rows: collision pairs, joint limits,
    servo or joint-friction rows, or bilateral rows."""
    has_limits = model.enable_joint_limits and model.has_joint_limits
    has_actuation_rows = bool(model.servo_dofs) or bool(model.friction_dofs)
    has_bilateral = bool(model.ball_pairs) or bool(model.weld_pairs) or bool(model.mimic_pairs)
    return bool(model.col_pairs) or has_limits or has_actuation_rows or has_bilateral


def step(model: Model, state: State, tau=None) -> State:
    """Full timestep with contacts and joint rows (the unconstrained step
    when the model has no collision pairs, limits, actuation or bilateral
    rows)."""
    return step_with_impulse(model, state, tau)[0]


def step_with_impulse(model: Model, state: State, tau=None, lam=None):
    """(next state, LCP impulse lam in the solve's dtype, or None for a
    step without LCP rows). Given `lam` from an earlier call at the same
    (state, tau), the step runs no solve (sim/constrained.py::
    step_and_impulse)."""
    if not _is_constrained(model):
        return step_unconstrained(model, state, tau), None
    from diffdart_tpu_torch.sim.constrained import step_and_impulse

    return step_and_impulse(model, state, tau, lam)


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


class _SavedImpulseStep(torch.autograd.Function):
    """One step of rollout_checkpointed. Forward: the step without a graph,
    keeping (q, v, tau, lam). Backward: the step again with that lam (no
    solve), then autograd through it. The model tensors that require grad
    are inputs (`params`, named by `names`), so their gradients flow."""

    @staticmethod
    def forward(ctx, model, names, q, v, tau, *params):
        with torch.no_grad():
            s, lam = step_with_impulse(model, State(q=q, v=v), tau)
        ctx.model, ctx.names, ctx.has_lam = model, names, lam is not None
        ctx.save_for_backward(q, v, tau, *params, *(() if lam is None else (lam,)))
        return s.q, s.v

    @staticmethod
    def backward(ctx, gq, gv):
        saved = ctx.saved_tensors
        lam = saved[-1] if ctx.has_lam else None
        q, v, tau, *params = saved[:-1] if ctx.has_lam else saved
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(need) for x, need in zip((q, v, tau, *params), needs)]
            model = ctx.model.replace(**dict(zip(ctx.names, xs[3:])))
            s, _ = step_with_impulse(model, State(q=xs[0], v=xs[1]), xs[2], lam)
            leaves = [x for x in xs if x.requires_grad]
            outs = [(o, g) for o, g in zip((s.q, s.v), (gq, gv)) if o.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in outs], leaves, [g for _, g in outs],
                                             allow_unused=True) if outs and leaves else ())
        return (None, None, *(next(grads, None) if x.requires_grad else None for x in xs))


def _grad_params(model: Model):
    """(names, tensors) of the model's tensor fields that require grad."""
    names = tuple(n for n in _ARRAY_FIELDS if (x := getattr(model, n)) is not None and x.requires_grad)
    return names, tuple(getattr(model, n) for n in names)


def rollout_checkpointed(model: Model, state: State, taus) -> State:
    """BPTT rollout with per-step recomputation: each step keeps its input
    state and its LCP impulse, and the backward pass re-runs the step with
    that impulse (one LCP solve per step in all, in the forward pass) before
    differentiating it. Returns the final state only."""
    if not torch.is_grad_enabled():
        return rollout_final(model, state, taus)
    names, params = _grad_params(model)
    q, v, t = state.q, state.v, state.t
    dt = model.dt.to(q.dtype)
    for k in range(taus.shape[0]):
        q, v = _SavedImpulseStep.apply(model, names, q, v, taus[k], *params)
        t = t + dt if t is not None else None
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
