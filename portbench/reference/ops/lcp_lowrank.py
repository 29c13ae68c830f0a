# Frozen copy of diffdart_tpu_torch/ops/lcp_lowrank.py, the benchmark's plain reference; imports
# rewritten to portbench.reference. Later changes to the program do not reach it.
"""Low-rank boxed-LCP solve of the vmap stack, with its implicit-function-
theorem (IFT) gradient, batch-first.

Counterpart of diffdart_tpu/ops/lcp_lowrank.py. A = J M^-1 J^T + cfm I with
J (B, D, nv) and nv << D; the polish and the IFT solves against the
active-set matrix G = F A T + (I - F) go through the Woodbury identity with
one (nv, nv) system per env:

    (cfm M + J^T (I+B) F J) u = J^T (I+B) r,   x = (r - F J u) / cfm.

`boxed_lcp_lowrank` applies `BoxedLcpLowrank`, a torch.autograd.Function
with both modes of the one linear tangent map `_lowrank_jvp_tangent`: its
`jvp` is the map (forward mode, the JAX package's `boxed_lcp_lowrank_jvp`)
and its backward the map's transpose (the JAX package builds it with
jax.linear_transpose; here zero tangent leaves that require grad go through
the map and torch.autograd.grad takes the cotangent back to them). Given a
`lam` from an earlier solve of the same problem, no solve runs (no sweeps,
no polish) and both modes are the IFT's at it: the per-step recomputation
of sim/step.py::rollout_checkpointed enters that way.

Every matmul here runs at full float32 precision: TF32 is turned off for
the solve (the Woodbury step amplifies rounding by about eps/cfm; the JAX
package forces "highest" precision for the same reason).
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd.function import once_differentiable

from portbench.reference.ops.lcp import (
    _bounds, _classify, _const_bound_values, _jacobi, _matvec, _nat_residual, _transpose)
from portbench.reference.ops.smalllinalg import cho_solve_small, cholesky_small, solve_nopivot_small

_TOL = 1e-8


@contextlib.contextmanager
def full_precision():
    """float32 matmuls without TF32 inside the block (restored after)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _T(x):
    return x.transpose(-1, -2)


def _apply_B(x, fr_bound, s, mu, fidx):
    """(Bx)_k = s_k mu_k x_{n(k)} on friction-bound rows."""
    xn = x[..., fidx.clamp(min=0)]
    return torch.where(fr_bound, s * mu * xn, 0.0)


def _applyT_B(y, fr_bound, s, mu, fidx, n):
    """(B^T y)_j = sum_{k: n(k)=j} s_k mu_k y_k."""
    vals = torch.where(fr_bound, s * mu * y, 0.0)
    out = torch.zeros(*y.shape[:-1], n, dtype=y.dtype, device=y.device)
    return out.index_add(-1, fidx.clamp(min=0), vals)


def _apply_B_mat(X, fr_bound, s, mu, fidx):
    """Row-wise B applied to a (B, D, k) matrix."""
    Xn = X[..., fidx.clamp(min=0), :]
    return torch.where(fr_bound.unsqueeze(-1), (s * mu).unsqueeze(-1) * Xn, 0.0)


def _solve_G_lowrank(r, J, L_M, cfm, free, fr_bound, s, mu, fidx):
    """Solve G x = r, G = F A T + (I-F), A = J Minv J^T + cfm I, T = (I+B)F,
    through the nv x nv Woodbury system. r is supported on the free set, and
    so is x."""
    F = free.to(r.dtype)
    JF = J * F.unsqueeze(-1)
    IB_JF = JF + _apply_B_mat(JF, fr_bound, s, mu, fidx)
    M = L_M @ _T(L_M)
    S = cfm * M + _T(J) @ IB_JF
    u = solve_nopivot_small(S, _matvec(_T(J), r + _apply_B(r, fr_bound, s, mu, fidx)))
    x = (r - _matvec(JF, u)) / cfm
    return x * F


def _polish_lowrank(lam0, J, L_M, cfm, A, b, lo, hi, mu, fidx, passes=3):
    """Active-set policy iteration with Woodbury inner solves; returns each
    env's best-by-residual iterate."""

    def one_pass(lam):
        free, fr_bound, s = _classify(lam, A, b, lo, hi, mu, fidx)
        F = free.to(lam.dtype)
        c = _const_bound_values(lam, lo, hi, mu, fidx, free)
        Ac = _matvec(J, cho_solve_small(L_M, _matvec(_T(J), c))) + cfm * c
        x = _solve_G_lowrank(-F * (b + Ac), J, L_M, cfm, free, fr_bound, s, mu, fidx)
        lam_new = x + _apply_B(x, fr_bound, s, mu, fidx) + c
        lo_eff, hi_eff = _bounds(lam_new, lo, hi, mu, fidx)
        lam_new = torch.minimum(torch.maximum(lam_new, lo_eff), hi_eff)
        finite = torch.isfinite(lam_new).all(dim=-1, keepdim=True)
        return torch.where(finite, lam_new, lam)

    best = lam0
    best_res = _nat_residual(lam0, A, b, lo, hi, mu, fidx)
    lam = lam0
    for _ in range(passes):
        lam = one_pass(lam)
        res = _nat_residual(lam, A, b, lo, hi, mu, fidx)
        better = res < best_res
        best = torch.where(better.unsqueeze(-1), lam, best)
        best_res = torch.where(better, res, best_res)
    return best


def _solve_impl(J, M, cfm, b, lo, hi, mu, fidx, iters, passes, sweeps=_jacobi, pivot_iters=16):
    """Boxed LCP with A = J M^-1 J^T + cfm I formed here. sweeps: the
    warm-start sweeps, `_jacobi` or ops/pallas_lcp.py::
    jacobi_sweeps_pallas_single (the CUDA kernel on CUDA tensors, _jacobi
    on CPU tensors), called as sweeps(A, b, lo, hi, mu, fidx, iters).
    pivot_iters > 0 adds the single-flip pivot refinement on float64
    solves. Returns lambda (B, D)."""
    with full_precision():
        L_M = cholesky_small(M)
        W = cho_solve_small(L_M, _T(J))  # (B, nv, D) = Minv J^T
        D = J.shape[-2]
        A = J @ W + cfm * torch.eye(D, dtype=J.dtype, device=J.device)
        lam = sweeps(A, b, lo, hi, mu, fidx, iters)
        lam = _polish_lowrank(lam, J, L_M, cfm, A, b, lo, hi, mu, fidx, passes)
        # the flip decisions need residuals resolvable below the stall
        # signal; the float32 Woodbury floor (~eps/cfm) is above it
        if pivot_iters and b.dtype == torch.float64:
            from portbench.reference.ops.lcp_pivot import pivot_refine

            lam = pivot_refine(lam, J, L_M, cfm, A, b, lo, hi, mu, fidx, iters=pivot_iters)
        return lam


def _lowrank_jvp_tangent(J, M, cfm, b, lo, hi, mu, fidx, lam, dJ, dM, dcfm, db, dlo, dhi, dmu):
    """The IFT tangent of lambda, linear in (dJ, dM, dcfm, db, dlo, dhi,
    dmu); None stands for a zero tangent."""
    D = J.shape[-2]
    L_M = cholesky_small(M)
    W = cho_solve_small(L_M, _T(J))
    A = J @ W + cfm * torch.eye(D, dtype=J.dtype, device=J.device)

    free, fr_bound, s = _classify(lam, A, b, lo, hi, mu, fidx)
    F = free.to(J.dtype)

    # bound motion w: friction bounds move with mu, constant bounds with lo/hi
    lam_n = lam[..., fidx.clamp(min=0)]
    w = torch.zeros_like(lam)
    if dmu is not None:
        w = w + torch.where(fr_bound, s * dmu * lam_n, 0.0)
    lo_eff, hi_eff = _bounds(lam, lo, hi, mu, fidx)
    scale = torch.clamp(torch.abs(lam), min=1.0)
    at_hi_c = (fidx < 0) & ~free & (lam >= hi_eff - _TOL * scale) & torch.isfinite(hi)
    at_lo_c = ((fidx < 0) & ~free & ~at_hi_c & (lam <= lo_eff + _TOL * scale) & torch.isfinite(lo)
               & (torch.abs(lo) > 0))
    if dhi is not None:
        w = w + torch.where(at_hi_c, dhi, 0.0)
    if dlo is not None:
        w = w + torch.where(at_lo_c, dlo, 0.0)

    # d(A lam) = dJ y + J dy + dcfm lam,  y = Minv J^T lam
    y = _matvec(W, lam)
    rho = _matvec(J, _matvec(W, w)) + cfm * w  # A w
    inner = None
    if dJ is not None:
        rho = rho + _matvec(dJ, y)
        inner = _matvec(_T(dJ), lam)
    if dM is not None:
        dMy = _matvec(dM, y)
        inner = -dMy if inner is None else inner - dMy
    if inner is not None:
        rho = rho + _matvec(J, cho_solve_small(L_M, inner))
    if dcfm is not None:
        rho = rho + dcfm.unsqueeze(-1) * lam
    if db is not None:
        rho = rho + db

    x = _solve_G_lowrank(-F * rho, J, L_M, cfm, free, fr_bound, s, mu, fidx)
    dlam = w + x + _apply_B(x, fr_bound, s, mu, fidx)
    # a degenerate active set makes the IFT solve blow up; zero the tangent
    # where a probe solve with a primal right-hand side misbehaves (the mask
    # is primal-only, so the map stays linear in the tangents)
    probe = _solve_G_lowrank(-F, J, L_M, cfm, free, fr_bound, s, mu, fidx)
    ok = torch.isfinite(probe).all(dim=-1) & (torch.amax(torch.abs(probe), dim=-1) < 1e12)
    return torch.where(ok.unsqueeze(-1), dlam, 0.0)


class BoxedLcpLowrank(torch.autograd.Function):
    """lam = the boxed LCP's solution, or the caller's `lam` when one is
    given (no solve runs); jvp = the IFT tangent map, backward = its
    transpose, evaluated by autograd through the map at zero tangents.
    Saves the inputs and lam: neither mode re-runs the sweeps or the
    polish."""

    @staticmethod
    def forward(J, M, cfm, b, lo, hi, mu, fidx, iters, passes, sweeps, pivot_iters, lam=None):
        if lam is not None:
            return lam.clone()
        return _solve_impl(J, M, cfm, b, lo, hi, mu, fidx, iters, passes, sweeps, pivot_iters)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:7], output)
        ctx.save_for_forward(*inputs[:7], output)
        ctx.fidx = inputs[7]

    @staticmethod
    def jvp(ctx, dJ, dM, dcfm, db, dlo, dhi, dmu, *_):
        J, M, cfm, b, lo, hi, mu, lam = ctx.saved_tensors
        with full_precision():
            return _lowrank_jvp_tangent(J, M, cfm, b, lo, hi, mu, ctx.fidx, lam, dJ, dM, dcfm, db,
                                        dlo, dhi, dmu)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        J, M, cfm, b, lo, hi, mu, lam = (x.detach() for x in ctx.saved_tensors)
        with full_precision():
            grads = _transpose(
                lambda *t: _lowrank_jvp_tangent(J, M, cfm, b, lo, hi, mu, ctx.fidx, lam, *t),
                (J, M, cfm, b, lo, hi, mu), ctx.needs_input_grad[:7], g)
        return grads + (None,) * 6


def boxed_lcp_lowrank(J, M, cfm, b, lo, hi, mu, fidx, iters=8, passes=3, sweeps=_jacobi,
                      pivot_iters=16, lam=None):
    """Solve the boxed LCP with A = J M^-1 J^T + cfm I (see _solve_impl);
    differentiable in J, M, cfm, b, lo, hi and mu through the IFT, forward
    and reverse. cfm is a 0-d tensor; fidx (D,) long. Given `lam` (B, D),
    no solve runs and the derivatives are the IFT's at it."""
    return BoxedLcpLowrank.apply(J, M, cfm, b, lo, hi, mu, fidx, iters, passes, sweeps,
                                 pivot_iters, lam)
