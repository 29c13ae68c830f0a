# Frozen copy of diffdart_tpu_torch/ops/lcp.py, the benchmark's plain reference; imports
# rewritten to portbench.reference. Later changes to the program do not reach it.
"""Batched boxed LCP with friction-index coupling and its implicit-function-
theorem (IFT) derivative, batch-first.

Counterpart of diffdart_tpu/ops/lcp.py: the effective bounds, the
active-set classification, the values of rows pinned at constant bounds,
the natural-map residual and `_jacobi`, the phased projected-Jacobi sweeps
(the plain version of the sweep kernel, ops/csrc/jacobi_sweeps.cu), which
the low-rank solver shares; and the dense solver of
`contact_solver='jacobi'` and `'pgs'`: `boxed_lcp` runs `_jacobi` or the
projected Gauss-Seidel rows of `_pgs`, then the active-set polish
(`_polish`, exact solves against G = F A T + (I - F), see `_build_T_G`).
`BoxedLcp` is a torch.autograd.Function: its `jvp` is the JAX package's
linear IFT rule (`_dense_jvp_tangent`), its backward that rule transposed,
by autograd through the rule at zero tangents. PGS runs its rows one after
another, D x iters small operations per solve; the JAX package runs it as
XLA, so there is no kernel for it.

Problem, per env and row i: w = A lam + b with lo_i <= lam_i <= hi_i, where
friction rows (fidx[i] >= 0) have moving bounds +-mu_i lam_{fidx[i]}; lam_i
at lo => w_i >= 0, at hi => w_i <= 0, strictly inside => w_i = 0.

Shapes: A (B, D, D); lam, b, lo, hi, mu (B, D); fidx (D,) long, shared by
every env.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from portbench.reference.math.lie import _mv as _matvec

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


def _pgs(A, b, lo, hi, mu, fidx, iters):
    """Projected Gauss-Seidel: one row at a time, in order, each against the
    impulses updated so far (the reference-fidelity sweeps)."""
    inv_diag = 1.0 / torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=1e-12)
    lam = torch.zeros_like(b)
    rows = fidx.tolist()
    for _ in range(iters):
        for i, f in enumerate(rows):
            cand = lam[..., i] - (_matvec(A[..., i:i + 1, :], lam)[..., 0] + b[..., i]) * inv_diag[..., i]
            if f >= 0:
                lo_i, hi_i = -mu[..., i] * lam[..., f], mu[..., i] * lam[..., f]
            else:
                lo_i, hi_i = lo[..., i], hi[..., i]
            lam[..., i] = torch.minimum(torch.maximum(cand, lo_i), hi_i)
    return lam


def _build_T_G(A, free, fr_bound, s, mu, fidx):
    """T = (I + B) F, B[i, fidx[i]] = s_i mu_i on friction rows at a moving
    bound, and the free-set matrix G = F A T + (I - F): (B, D, D) each."""
    D = A.shape[-1]
    F = free.to(A.dtype)
    Bvals = torch.where(fr_bound, s * mu, 0.0)
    cols = fidx.clamp(min=0).expand_as(Bvals).unsqueeze(-1)
    Bm = torch.zeros_like(A).scatter(-1, cols, Bvals.unsqueeze(-1))
    T = (torch.eye(D, dtype=A.dtype, device=A.device) + Bm) * F.unsqueeze(-2)
    G = F.unsqueeze(-1) * (A @ T) + torch.diag_embed(1.0 - F)
    return T, G


def _solve(G, r):
    """x with G x = r per env (LU with partial pivoting); a singular G gives
    non-finite values rather than an error (the callers guard them)."""
    return torch.linalg.solve_ex(G, r.unsqueeze(-1), check_errors=False)[0].squeeze(-1)


def _polish(lam0, A, b, lo, hi, mu, fidx, passes: int = 4):
    """Active-set policy iteration: classify, solve exactly on the free set
    with the friction-bound coupling folded in, project, repeat; returns
    each env's best-by-residual iterate."""

    def one_pass(lam):
        free, fr_bound, s = _classify(lam, A, b, lo, hi, mu, fidx)
        T, G = _build_T_G(A, free, fr_bound, s, mu, fidx)
        F = free.to(A.dtype)
        c = _const_bound_values(lam, lo, hi, mu, fidx, free)
        lam_new = _matvec(T, _solve(G, -F * (b + _matvec(A, c)))) + c
        lo_eff, hi_eff = _bounds(lam_new, lo, hi, mu, fidx)
        lam_new = torch.minimum(torch.maximum(lam_new, lo_eff), hi_eff)
        return torch.where(torch.isfinite(lam_new).all(dim=-1, keepdim=True), lam_new, lam)

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


def _dense_jvp_tangent(A, b, lo, hi, mu, fidx, lam, dA, db, dlo, dhi, dmu):
    """The IFT tangent of lambda at the solution lam, linear in (dA, db,
    dlo, dhi, dmu); None stands for a zero tangent:
    G dlam_hat = -F (dA lam + A w + db), dlam = w + T dlam_hat, where w is
    the motion of the active bounds."""
    free, fr_bound, s = _classify(lam, A, b, lo, hi, mu, fidx)
    T, G = _build_T_G(A, free, fr_bound, s, mu, fidx)
    F = free.to(A.dtype)
    w = torch.zeros_like(lam)
    if dmu is not None:
        w = w + torch.where(fr_bound, s * dmu * lam[..., fidx.clamp(min=0)], 0.0)
    lo_eff, hi_eff = _bounds(lam, lo, hi, mu, fidx)
    scale = torch.clamp(torch.abs(lam), min=1.0)
    at_hi_c = (fidx < 0) & ~free & (lam >= hi_eff - _TOL * scale) & torch.isfinite(hi)
    at_lo_c = ((fidx < 0) & ~free & ~at_hi_c & (lam <= lo_eff + _TOL * scale) & torch.isfinite(lo)
               & (torch.abs(lo) > 0))
    if dhi is not None:
        w = w + torch.where(at_hi_c, dhi, 0.0)
    if dlo is not None:
        w = w + torch.where(at_lo_c, dlo, 0.0)
    rhs = _matvec(A, w)
    if dA is not None:
        rhs = rhs + _matvec(dA, lam)
    if db is not None:
        rhs = rhs + db
    return w + _matvec(T, _solve(G, -F * rhs))


class BoxedLcp(torch.autograd.Function):
    """lam = the dense boxed LCP's solution (sweeps, then the polish), or
    the caller's `lam` when one is given (no solve runs); jvp = the IFT
    rule, backward = its transpose. Differentiable in A, b, lo, hi, mu."""

    @staticmethod
    def forward(A, b, lo, hi, mu, fidx, iters, solver, polish, lam=None):
        if lam is not None:
            return lam.clone()
        lam = (_jacobi if solver == "jacobi" else _pgs)(A, b, lo, hi, mu, fidx, iters)
        return _polish(lam, A, b, lo, hi, mu, fidx) if polish else lam

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, b, lo, hi, mu, fidx = inputs[:6]
        ctx.save_for_backward(A, b, lo, hi, mu, output)
        ctx.save_for_forward(A, b, lo, hi, mu, output)
        ctx.fidx = fidx

    @staticmethod
    def jvp(ctx, dA, db, dlo, dhi, dmu, *_):
        A, b, lo, hi, mu, lam = ctx.saved_tensors
        return _dense_jvp_tangent(A, b, lo, hi, mu, ctx.fidx, lam, dA, db, dlo, dhi, dmu)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        A, b, lo, hi, mu, lam = (x.detach() for x in ctx.saved_tensors)
        grads = _transpose(lambda *t: _dense_jvp_tangent(A, b, lo, hi, mu, ctx.fidx, lam, *t),
                           (A, b, lo, hi, mu), ctx.needs_input_grad[:5], g)
        return grads + (None,) * 5


def _transpose(tangent_map, primals, needs, g):
    """The transpose of a linear tangent map at cotangent g: zero tangents
    that require grad (None where no gradient is needed) go through the
    map, and torch.autograd.grad takes g back to them."""
    if not any(needs):
        return (None,) * len(primals)
    with torch.enable_grad():
        tangents = [torch.zeros_like(x, requires_grad=True) if need else None
                    for x, need in zip(primals, needs)]
        out = tangent_map(*tangents)
        leaves = [t for t in tangents if t is not None]
        if not out.requires_grad:
            return (None,) * len(primals)
        grads = iter(torch.autograd.grad(out, leaves, g, allow_unused=True))
    return tuple(next(grads) if t is not None else None for t in tangents)


def boxed_lcp(A, b, lo, hi, mu, fidx, iters=30, solver="jacobi", polish=True, lam=None):
    """Solve the dense boxed LCP (A (B, D, D); b, lo, hi, mu (B, D); fidx
    (D,) long): solver 'jacobi' (the phased sweeps) or 'pgs' (Gauss-Seidel
    rows), then the active-set polish if `polish`. Differentiable in A, b,
    lo, hi and mu, forward and reverse, through the IFT. Given `lam` (a
    solution from an earlier call on the same problem), no solve runs and
    the derivatives are the IFT's at it."""
    return BoxedLcp.apply(A, b, lo, hi, mu, fidx, iters, solver, polish, lam)
