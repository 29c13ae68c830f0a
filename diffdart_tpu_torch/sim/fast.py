"""Auto-selecting fast rollout: the fused path when the model is in the fused
subset (on CUDA also within the fused-step kernel's size caps) and its
parameters do not require grad, the vmap stack otherwise.

Counterpart of diffdart_tpu/sim/fast.py. Batch layout is the ordinary
batch-first (B, nq)/(B, nv) State; the SoA re-layout of the fused path
happens inside ops/fused_step.py. The TPU's B % 1024 rule does not apply:
the SoA layout takes any B.

Where the fused path cannot be used, rollout_fast warns (UserWarning, with
the reason) and runs sim/step.py::rollout_checkpointed on the vmap stack,
as the JAX package does; gradients with respect to model parameters (mass,
inertia, friction, ...) exist only there.
"""
from __future__ import annotations

import warnings

from diffdart_tpu_torch.dynamics.model import Model, State
from diffdart_tpu_torch.ops.fused_step import build_fused_step, rollout_tiled
from diffdart_tpu_torch.sim.step import rollout_checkpointed
from diffdart_tpu_torch.sim.tilestep import TileStepUnsupported

_PARAM_FIELDS = ("X_rot", "X_pos", "axis", "axis2", "mass", "com", "inertia", "damping",
                 "armature", "spring_stiff", "q_rest", "q_lo", "q_hi", "gravity", "dt",
                 "geom_size", "geom_rot", "geom_pos", "geom_friction", "geom_restitution",
                 "servo_target", "force_limit", "joint_friction")


def supports_fused(model: Model) -> bool:
    """True if `model` is in the fused subset (joint types, contact pair
    types, row types; see sim/tilestep.py). Builds the model's cached
    FusedStep on the way, which the rollout then reuses."""
    try:
        build_fused_step(model)
        return True
    except TileStepUnsupported:
        return False


def _fallback_reason(model: Model, device) -> str | None:
    """Why the fused path can't be used on `device`, or None if it can.

      * model parameters must not require grad: the fused step bakes them as
        constants, so their gradients would silently vanish;
      * the model must be inside the fused subset (supports_fused);
      * on CUDA, the model must also fit the fused-step kernel's size caps
        (FusedStep.unsupported_reason); on the CPU the plain
        version has none.
    """
    if any(getattr(model, f) is not None and getattr(model, f).requires_grad for f in _PARAM_FIELDS):
        return (
            "model parameters require grad; the fused path bakes them as "
            "constants, so using it would silently zero those gradients"
        )
    if not supports_fused(model):
        return "model is outside the fused subset (see sim/tilestep.py header)"
    reason = build_fused_step(model).unsupported_reason  # cached with the model's FusedStep
    if device.type == "cuda" and reason:
        return f"the fused-step kernel cannot run this model: {reason}"
    return None


def rollout_fast(model: Model, state: State, taus) -> State:
    """Batched rollout on the fastest available path. state: batched State
    with (B, nq)/(B, nv) fields; taus: (T, B, nv). Returns the final State.

    On the fused path, CUDA tensors launch the fused-step kernel once per
    step (and the VJP kernel once per step of the backward pass), CPU
    tensors run its plain version; gradients flow wrt state and taus. Where
    the fused path cannot be used, a UserWarning names the reason (silence it
    with a `warnings` filter) and the vmap stack's per-step-recomputing
    rollout runs instead; gradients then also flow wrt model parameters."""
    reason = _fallback_reason(model, state.q.device)
    if reason is None:
        return rollout_tiled(model, state, taus)
    warnings.warn(f"rollout_fast: falling back to the slower vmap path: {reason}",
                  UserWarning, stacklevel=2)
    return rollout_checkpointed(model, state, taus)
