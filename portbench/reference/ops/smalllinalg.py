# Frozen copy of diffdart_tpu_torch/ops/smalllinalg.py, the benchmark's plain reference; imports
# rewritten to portbench.reference. Later changes to the program do not reach it.
"""Unrolled small-matrix linear algebra, batched over leading axes.

Counterpart of diffdart_tpu/ops/smalllinalg.py. The algebra is the same
pivot-free, unrolled one: the Woodbury solve of the LCP polish amplifies
rounding by about eps/cfm, so another factorisation (torch.linalg's
pivoted LU, say) would change the answers. Loops run over the static size;
every step is one batched tensor op over all leading axes, out of place, so
autograd differentiates it.

Right-hand sides are (..., n) vectors or (..., n, k) matrices: `b.ndim ==
A.ndim` marks the matrix case.
"""
from __future__ import annotations

import torch


def cholesky_small(A):
    """(..., n, n) SPD -> lower-triangular L with A = L L^T (column by
    column, unrolled over the static size)."""
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    cols = []
    for j in range(n):
        c = A[..., :, j]
        if j:
            Lp = torch.stack(cols, dim=-1)  # (..., n, j)
            c = c - (Lp @ Lp[..., j, :].unsqueeze(-1)).squeeze(-1)
        d = torch.sqrt(torch.clamp(c[..., j], min=1e-30))
        col = torch.where(rows > j, c / d.unsqueeze(-1), torch.zeros_like(c))
        col = torch.where(rows == j, d.unsqueeze(-1).expand_as(c), col)
        cols.append(col)
    return torch.stack(cols, dim=-1)


def _as_mat(b, A):
    return (b, False) if b.ndim == A.ndim else (b.unsqueeze(-1), True)


def tri_solve_lower(L, b):
    """Solve L x = b, L (..., n, n) lower-triangular."""
    b, vec = _as_mat(b, L)
    n = L.shape[-1]
    xs = []
    for i in range(n):
        acc = b[..., i, :]
        if i:
            acc = acc - (L[..., i, None, :i] @ torch.stack(xs, dim=-2)).squeeze(-2)
        xs.append(acc / L[..., i, i, None])
    x = torch.stack(xs, dim=-2)
    return x.squeeze(-1) if vec else x


def tri_solve_upper(U, b):
    """Solve U x = b, U (..., n, n) upper-triangular."""
    b, vec = _as_mat(b, U)
    n = U.shape[-1]
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        acc = b[..., i, :]
        if i + 1 < n:
            acc = acc - (U[..., i, None, i + 1:] @ torch.stack(xs[i + 1:], dim=-2)).squeeze(-2)
        xs[i] = acc / U[..., i, i, None]
    x = torch.stack(xs, dim=-2)
    return x.squeeze(-1) if vec else x


def cho_solve_small(L, b):
    """Solve (L L^T) x = b given the Cholesky factor."""
    return tri_solve_upper(L.transpose(-1, -2), tri_solve_lower(L, b))


def spd_solve_small(A, b):
    """Solve SPD A x = b via the unrolled Cholesky."""
    return cho_solve_small(cholesky_small(A), b)


def _safe_piv(piv):
    """Dead pivots (|piv| <= 1e-20, exactly singular active sets) contribute
    nothing: their factor and solution are zeroed instead of divided, so no
    inf is created; the finite garbage is discarded by the callers' probe
    guards. Returns (pivot with dead entries set to 1, dead mask)."""
    dead = torch.abs(piv) <= 1e-20
    return torch.where(dead, torch.ones_like(piv), piv), dead


def solve_nopivot_small(A, b):
    """Solve (..., n, n) A x = b by Gaussian elimination WITHOUT pivoting:
    valid for the near-SPD active-set systems of the LCP, whose diagonal is
    bounded below by the CFM regulariser. float64 keeps the plain algorithm;
    other dtypes zero dead pivots (_safe_piv), so singular systems give
    finite garbage, never inf or NaN, as in the JAX package."""
    b, vec = _as_mat(b, A)
    n = A.shape[-1]
    guard = A.dtype != torch.float64
    for k in range(n - 1):
        piv = A[..., k, k]
        if guard:
            piv, dead = _safe_piv(piv)
            factor = torch.where(dead.unsqueeze(-1), torch.zeros_like(A[..., k + 1:, k]),
                                 A[..., k + 1:, k] / piv.unsqueeze(-1))
        else:
            factor = A[..., k + 1:, k] / piv.unsqueeze(-1)
        f = factor.unsqueeze(-1)
        A = torch.cat([A[..., :k + 1, :],
                       torch.cat([A[..., k + 1:, :k], A[..., k + 1:, k:] - f * A[..., k, None, k:]],
                                 dim=-1)], dim=-2)
        b = torch.cat([b[..., :k + 1, :], b[..., k + 1:, :] - f * b[..., k, None, :]], dim=-2)
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        acc = b[..., i, :]
        if i + 1 < n:
            acc = acc - (A[..., i, None, i + 1:] @ torch.stack(xs[i + 1:], dim=-2)).squeeze(-2)
        if guard:
            piv, dead = _safe_piv(A[..., i, i])
            xs[i] = torch.where(dead.unsqueeze(-1), torch.zeros_like(acc), acc / piv.unsqueeze(-1))
        else:
            xs[i] = acc / A[..., i, i, None]
    x = torch.stack(xs, dim=-2)
    return x.squeeze(-1) if vec else x


def inv_small_spd(A):
    """Explicit inverse of a small SPD matrix via the unrolled Cholesky."""
    n = A.shape[-1]
    return spd_solve_small(A, torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape))
