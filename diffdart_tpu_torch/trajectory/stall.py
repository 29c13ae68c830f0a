"""Contact-solver stalls during trajectory optimization, surfaced as a
warning.

Counterpart of diffdart_tpu/trajectory/stall.py. In plain float32 the
boxed LCP can settle on a fixed point that is not the LCP's solution
(rank-deficient contact sets, ops/lcp_pivot.py); an optimization over such
steps freezes without a word. The natural-map residual of every step's LCP
(sim/constrained.py::solver_diagnostics) is checked along the optimized
trajectory, and SolverStallWarning fires where it exceeds the stall
threshold.

The check runs eagerly (torch has no jit), once per call. The diagnostic
solve runs in float64 (lcp_dtype='f64'), as the JAX package's does when
x64 is enabled; torch always has float64, on the CPU and on the card.
"""
from __future__ import annotations

import warnings

import torch

from diffdart_tpu_torch.dynamics.model import Model, State


class SolverStallWarning(UserWarning):
    """The contact LCP failed to converge somewhere along the trajectory."""


def stall_threshold(model: Model, dtype) -> float:
    """Residuals above this are a stall, not the precision floor. The
    diagnostic solve runs in float64 (rollout_solver_residuals), whose
    Woodbury floor is about 1e-5, so the threshold is 1e-3 for every state
    dtype."""
    return 1e-3


def rollout_solver_residuals(model: Model, xs, us, control_map=None):
    """(T,) natural-map LCP residual at every step of a trajectory in the
    flat layout of trajectory/ilqr.py: xs (T+1, nq+nv), us (T, nu). The T
    steps are one batch of T envs, solved in float64."""
    from diffdart_tpu_torch.sim.constrained import solver_diagnostics

    md = model if model.lcp_dtype == "f64" else model.replace(lcp_dtype="f64")
    nq = model.nq
    x = xs[:-1]
    tau = us if control_map is None else control_map(us)
    with torch.no_grad():
        return solver_diagnostics(md, State(q=x[..., :nq], v=x[..., nq:]), tau)


def _emit(max_res: float, threshold: float, context: str, promote_hint: bool):
    if max_res <= threshold:
        return
    hint = ("set Model.lcp_dtype='f64' (the float64 island for the LCP solve) and/or raise "
            "Model.lcp_pivot_iters" if promote_hint
            else "raise Model.lcp_pivot_iters / Model.contact_iters")
    warnings.warn(
        f"contact-solver stall during {context}: max LCP natural-map residual {max_res:.3e} "
        f"exceeds the stall threshold {threshold:.2e} somewhere along the optimized trajectory; "
        f"the contact impulses and their gradients are unreliable there and the optimization "
        f"may silently freeze; {hint}.",
        SolverStallWarning, stacklevel=3)


def check_trajectory_stall(model: Model, xs, us, control_map=None,
                           context: str = "trajectory optimization",
                           threshold: float | None = None):
    """The largest LCP residual along (xs, us), a 0-d tensor; warns
    (SolverStallWarning) if it crosses the stall threshold."""
    res = rollout_solver_residuals(model, xs, us, control_map)
    max_res = res.max() if res.numel() else torch.zeros((), dtype=xs.dtype, device=xs.device)
    thr = stall_threshold(model, xs.dtype) if threshold is None else threshold
    _emit(float(max_res), thr, context, model.lcp_dtype != "f64")
    return max_res
