# Frozen copy of diffdart_tpu_torch/ops/lcp_pivot.py, the benchmark's plain reference; imports
# rewritten to portbench.reference. Later changes to the program do not reach it.
"""Single-flip principal pivoting refinement of the boxed LCP, batch-first.

Counterpart of diffdart_tpu/ops/lcp_pivot.py: the complementarity class of
each row (FREE, LO, HI) is explicit state, and each iteration flips the one
most-violated row and re-solves the active set through the same Woodbury
solve as the polish; a second canonical start (normals FREE, frictions LO)
catches the rare trapped search. The best-by-residual iterate is returned,
so the refinement never makes an env worse.

The JAX package's while_loop runs per env under vmap; here every env
carries a `done` mask and its own budget, and the loop runs while any env
is pending, updating only those. Float64 solves only (lcp_lowrank.py).
"""
from __future__ import annotations

import torch

from portbench.reference.ops.lcp import _bounds, _matvec, _nat_residual
from portbench.reference.ops.lcp_lowrank import _apply_B, _solve_G_lowrank
from portbench.reference.ops.smalllinalg import cho_solve_small

FREE, LO, HI = 0, 1, 2

_VIOL_TOL = 1e-9


def _classes_from_lam(lam, A, b, lo, hi, mu, fidx):
    """Initial explicit classification from an iterate (the tolerances of
    ops/lcp.py::_classify)."""
    lo_eff, hi_eff = _bounds(lam, lo, hi, mu, fidx)
    scale = torch.clamp(torch.abs(lam), min=1.0)
    at_lo = lam <= lo_eff + 1e-8 * scale
    at_hi = lam >= hi_eff - 1e-8 * scale
    free = ~at_lo & ~at_hi
    return torch.where(free, FREE, torch.where(at_hi & ~at_lo, HI, LO))


def _solve_classes(cls, J, L_M, cfm, b, lo, hi, mu, fidx):
    """Active-set solve for an explicit classification; returns the
    unprojected lam (violations are measured on it)."""
    is_fr = fidx >= 0
    free = cls == FREE
    fr_bound = is_fr & ~free
    s = torch.where(cls == HI, 1.0, -1.0).to(b.dtype)
    at_lo_c = ~is_fr & (cls == LO) & torch.isfinite(lo)
    at_hi_c = ~is_fr & (cls == HI) & torch.isfinite(hi)
    c = torch.where(at_hi_c, hi, 0.0) + torch.where(at_lo_c, lo, 0.0)
    F = free.to(b.dtype)
    Ac = _matvec(J, cho_solve_small(L_M, _matvec(J.transpose(-1, -2), c))) + cfm * c
    x = _solve_G_lowrank(-F * (b + Ac), J, L_M, cfm, free, fr_bound, s, mu, fidx)
    return x + _apply_B(x, fr_bound, s, mu, fidx) + c


def _pivot_from(cls, best, best_res, J, L_M, cfm, A, b, lo, hi, mu, fidx, zero_width, budget):
    """Up to budget[e] single flips for env e from classification cls; folds
    the best-by-residual iterate into (best, best_res)."""
    is_fr = fidx >= 0
    done = torch.zeros_like(best_res, dtype=torch.bool)
    it = 0
    while True:
        active = ~done & (it < budget)
        if not bool(active.any()):
            return best, best_res
        lam_raw = _solve_classes(cls, J, L_M, cfm, b, lo, hi, mu, fidx)
        w_raw = _matvec(A, lam_raw) + b
        ok = torch.isfinite(lam_raw).all(-1) & torch.isfinite(w_raw).all(-1)
        lam_n = lam_raw[..., fidx.clamp(min=0)]
        lo_r = torch.where(is_fr, -mu * torch.abs(lam_n), lo)
        hi_r = torch.where(is_fr, mu * torch.abs(lam_n), hi)
        zero = torch.zeros_like(lam_raw)
        v_lo = torch.where(cls == FREE, torch.clamp(lo_r - lam_raw, min=0.0), zero)
        v_hi = torch.where(cls == FREE, torch.clamp(lam_raw - hi_r, min=0.0), zero)
        v_w_lo = torch.where(cls == LO, torch.clamp(-w_raw, min=0.0), zero)
        v_w_hi = torch.where(cls == HI, torch.clamp(w_raw, min=0.0), zero)
        viol = torch.where(zero_width, zero, v_lo + v_hi + v_w_lo + v_w_hi)
        viol = torch.where(torch.isfinite(viol), viol, zero)
        lo_eff, hi_eff = _bounds(lam_raw, lo, hi, mu, fidx)
        lam_p = torch.minimum(torch.maximum(lam_raw, lo_eff), hi_eff)
        res = _nat_residual(lam_p, A, b, lo, hi, mu, fidx)
        better = active & ok & (res < best_res)
        best = torch.where(better.unsqueeze(-1), lam_p, best)
        best_res = torch.where(better, res, best_res)
        # flip the most-violated row (no-op when consistent or non-finite)
        k = torch.argmax(viol, dim=-1, keepdim=True)
        scale = 1.0 + torch.amax(torch.abs(lam_p), dim=-1)
        any_viol = torch.amax(viol, dim=-1) > _VIOL_TOL * scale
        cls_k = cls.gather(-1, k)
        new_k = torch.where(cls_k == FREE,
                            torch.where(v_hi.gather(-1, k) > v_lo.gather(-1, k), HI, LO), FREE)
        flip = (active & any_viol & ok).unsqueeze(-1)
        cls = torch.where(flip, cls.scatter(-1, k, new_k), cls)
        done = done | (active & (~any_viol | ~ok))
        it += 1


def pivot_refine(lam, J, L_M, cfm, A, b, lo, hi, mu, fidx, iters=16, tol=1e-6):
    """Refine an LCP iterate toward pivot-solver accuracy: single flips from
    the iterate's own classification and, for envs still above `tol`, from
    the canonical start. Envs already below `tol` get a zero budget."""
    if iters <= 0:
        return lam
    is_fr = fidx >= 0
    zero_width = (~is_fr & (hi <= lo + 1e-30)) | (is_fr & (mu <= 0))
    best = lam
    best_res = _nat_residual(lam, A, b, lo, hi, mu, fidx)
    budget0 = torch.where(best_res > tol, iters, 0)
    cls0 = torch.where(zero_width, LO, _classes_from_lam(lam, A, b, lo, hi, mu, fidx))
    best, best_res = _pivot_from(cls0, best, best_res, J, L_M, cfm, A, b, lo, hi, mu, fidx,
                                 zero_width, budget0)
    cls1 = torch.where(zero_width, LO, torch.where(is_fr, LO, FREE)).expand_as(lam)
    budget = torch.where(best_res > tol, iters, 0)
    best, best_res = _pivot_from(cls1, best, best_res, J, L_M, cfm, A, b, lo, hi, mu, fidx,
                                 zero_width, budget)
    return best


def solve_residual(lam, A, b, lo, hi, mu, fidx):
    """(B,) natural-map residual per problem, the diagnostic of a stalled
    solve: about 1e-6 or below, pivot-accurate; 1e-2 or above, the solve
    (and with it the IFT gradient's active set) did not converge."""
    return _nat_residual(lam, A, b, lo, hi, mu, fidx)
