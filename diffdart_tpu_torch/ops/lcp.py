"""Boxed-LCP helpers with friction-index coupling, batch-first.

Counterpart of the helpers of diffdart_tpu/ops/lcp.py that the low-rank
solver uses: the effective bounds, the active-set classification, the
values of rows pinned at constant bounds, the natural-map residual, and
`_jacobi`, the phased projected-Jacobi sweeps, which is the plain version of
the sweep kernel (ops/csrc/jacobi_sweeps.cu). The dense `boxed_lcp`
(`contact_solver='jacobi'` or `'pgs'`) is not ported (ROADMAP Queue 1
item 4).

Problem, per env and row i: w = A lam + b with lo_i <= lam_i <= hi_i, where
friction rows (fidx[i] >= 0) have moving bounds +-mu_i lam_{fidx[i]}; lam_i
at lo => w_i >= 0, at hi => w_i <= 0, strictly inside => w_i = 0.

Shapes: A (B, D, D); lam, b, lo, hi, mu (B, D); fidx (D,) long, shared by
every env.
"""
from __future__ import annotations

import torch

from diffdart_tpu_torch.math.lie import _mv as _matvec

_TOL = 1e-8


def _bounds(lam, lo, hi, mu, fidx):
    """Effective bounds given the current lambda (friction coupling)."""
    lam_n = lam[..., fidx]  # fidx = -1 on non-friction rows; masked below
    is_fr = fidx >= 0
    return torch.where(is_fr, -mu * lam_n, lo), torch.where(is_fr, mu * lam_n, hi)


def _jacobi(A, b, lo, hi, mu, fidx, iters):
    """Phased projected Jacobi with adaptive row scaling
    omega_i = clip(diag_i / rowsum_i, 0.3, 0.9): each sweep updates the
    normal/limit rows, then the friction rows against the fresh normals.
    The plain version of the sweep kernel."""
    is_fr = fidx >= 0
    diag = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=1e-12)
    rowsum = torch.clamp(torch.sum(torch.abs(A), dim=-1), min=1e-12)
    row_scale = torch.clamp(diag / rowsum, 0.3, 0.9) / diag

    def half_sweep(lam, update_mask):
        r = _matvec(A, lam) + b
        cand = lam - r * row_scale
        lo_eff, hi_eff = _bounds(lam, lo, hi, mu, fidx)
        cand = torch.minimum(torch.maximum(cand, lo_eff), hi_eff)
        return torch.where(update_mask, cand, lam)

    lam = torch.zeros_like(b)
    for _ in range(iters):
        lam = half_sweep(lam, ~is_fr)
        lam = half_sweep(lam, is_fr)
    return lam


def _classify(lam, A, b, lo, hi, mu, fidx):
    """Free / friction-bound masks and the sign of the active friction bound
    at the solution."""
    lo_eff, hi_eff = _bounds(lam, lo, hi, mu, fidx)
    scale = torch.clamp(torch.abs(lam), min=1.0)
    at_lo = lam <= lo_eff + _TOL * scale
    at_hi = lam >= hi_eff - _TOL * scale
    degenerate = at_lo & at_hi
    free = ~at_lo & ~at_hi & ~degenerate
    s = torch.where(at_hi, 1.0, -1.0).to(lam.dtype)
    fr_bound = (fidx >= 0) & (at_lo | at_hi) & ~degenerate
    return free, fr_bound, s


def _const_bound_values(lam, lo, hi, mu, fidx, free):
    """c: the values of rows pinned at constant finite bounds (servo and
    joint-friction rows at +-F dt; zero for separating normals and
    limits)."""
    lo_eff, hi_eff = _bounds(lam, lo, hi, mu, fidx)
    scale = torch.clamp(torch.abs(lam), min=1.0)
    not_fr = fidx < 0
    at_hi_c = not_fr & ~free & (lam >= hi_eff - _TOL * scale) & torch.isfinite(hi)
    at_lo_c = not_fr & ~free & ~at_hi_c & (lam <= lo_eff + _TOL * scale) & torch.isfinite(lo)
    return torch.where(at_hi_c, hi, 0.0) + torch.where(at_lo_c, lo, 0.0)


def _nat_residual(lam, A, b, lo, hi, mu, fidx):
    """Natural-map residual per env, ||lam - proj(lam - w)||_inf: zero iff
    lam solves the boxed LCP."""
    w = _matvec(A, lam) + b
    lo_eff, hi_eff = _bounds(lam, lo, hi, mu, fidx)
    proj = torch.minimum(torch.maximum(lam - w, lo_eff), hi_eff)
    return torch.amax(torch.abs(lam - proj), dim=-1)
