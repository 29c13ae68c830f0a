"""Front door of the fused rollout.

Counterpart of diffdart_tpu/sim/fast.py. Batch layout is the ordinary
batch-first (B, nq)/(B, nv) State; the SoA re-layout happens inside
ops/fused_step.py. The TPU's B % 1024 rule does not apply: the SoA layout
takes any B.

Not yet supported: the vmap fallback path (sim/step.py of the JAX package is
not ported). Where the JAX version falls back, this one raises
NotImplementedError with the reason.
"""
from __future__ import annotations

from diffdart_tpu_torch.dynamics.model import Model, State
from diffdart_tpu_torch.ops.fused_step import build_fused_step, rollout_tiled
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


def _fallback_reason(model: Model) -> str | None:
    """Why the fused path can't be used, or None if it can.

      * model parameters must not require grad: the fused step bakes them as
        constants, so their gradients would silently vanish;
      * the model must be inside the fused subset (supports_fused).
    """
    if any(getattr(model, f) is not None and getattr(model, f).requires_grad for f in _PARAM_FIELDS):
        return (
            "model parameters require grad; the fused path bakes them as "
            "constants, so using it would silently zero those gradients"
        )
    if not supports_fused(model):
        return "model is outside the fused subset (see sim/tilestep.py header)"
    return None


def rollout_fast(model: Model, state: State, taus) -> State:
    """Batched rollout on the fused path. state: batched State with
    (B, nq)/(B, nv) fields; taus: (T, B, nv). Returns the final State.
    Gradients flow wrt state and taus on both devices. On CUDA tensors every
    step is one launch of the fused-step kernel, and the backward pass one
    launch of the VJP kernel per step; on CPU tensors the plain version runs
    and autograd differentiates it."""
    reason = _fallback_reason(model)
    if reason is not None:
        raise NotImplementedError(
            f"rollout_fast: the JAX package falls back to its vmap path here, "
            f"which is not ported yet: {reason}")
    return rollout_tiled(model, state, taus)
