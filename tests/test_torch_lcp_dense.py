"""The dense boxed LCP of the torch port (ops/lcp.py::boxed_lcp, the
solver of contact_solver='jacobi' and 'pgs') and the forward mode of the
low-rank one (ops/lcp_lowrank.py::BoxedLcpLowrank.jvp) against the JAX
package, float64 on the CPU, on seeded random LCPs with every row type:
contact normals with two friction rows each (moving bounds), constant-box
rows (finite lo and hi) and bilateral rows (lo = -inf, hi = +inf).
A = J M^-1 J^T + cfm I with cfm = 1e-2, so that the problems are well
conditioned and both packages land on the same active set.

* boxed_lcp, 'jacobi' and 'pgs', with and without the polish: lambda
  against jax.vmap of the JAX boxed_lcp within 1e-10 relative to
  max(1, |lambda|) (the same sweeps and solves, another summation order);
  its jvp (torch.autograd.forward_ad through BoxedLcp.jvp) against jax.jvp,
  and its vjp (BoxedLcp.backward) against jax.vjp, each within 1e-8 times
  the largest magnitude.
* BoxedLcpLowrank's jvp under forward_ad against jax.jvp of
  boxed_lcp_lowrank_jvp (the same limit), and a dot-product test of its jvp
  against its backward: <g, J t> = <J^T g, t> to 1e-10 relative.
* A lambda given to either Function: no solve runs, and the derivatives
  are the same as after the solve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from diffdart_tpu.ops.lcp import boxed_lcp as jax_boxed_lcp
from diffdart_tpu.ops.lcp_lowrank import boxed_lcp_lowrank_jvp as jax_lowrank_jvp
from diffdart_tpu_torch.ops import lcp as L
from diffdart_tpu_torch.ops.lcp_lowrank import boxed_lcp_lowrank

from test_torch_vmap_dynamics import T, close

B, NC, NBOX, NBI, NV, CFM = 6, 3, 2, 2, 8, 1e-2
D = 3 * NC + NBOX + NBI
FIDX = np.array([-1] * NC + list(range(NC)) * 2 + [-1] * (NBOX + NBI))
CASES = [("jacobi", True), ("jacobi", False), ("pgs", True), ("pgs", False)]
ITERS = 30


def _problem(seed=0):
    """Numpy (J, M, b, lo, hi, mu) (B, ...) and the tangents of each."""
    rng = np.random.RandomState(seed)
    J = rng.randn(B, D, NV)
    X = rng.randn(B, NV, NV)
    M = X @ X.transpose(0, 2, 1) + NV * np.eye(NV)
    b = rng.randn(B, D)
    lo = np.concatenate([np.zeros((B, 3 * NC)), -0.3 - rng.rand(B, NBOX), np.full((B, NBI), -np.inf)], 1)
    hi = np.concatenate([np.full((B, NC), np.inf), np.zeros((B, 2 * NC)), 0.3 + rng.rand(B, NBOX),
                         np.full((B, NBI), np.inf)], 1)
    mu = np.concatenate([np.zeros((B, NC)), 0.3 + 0.5 * rng.rand(B, 2 * NC), np.zeros((B, NBOX + NBI))], 1)
    tangents = [rng.randn(*x.shape) for x in (J, M, b, lo, hi, mu)]
    tangents[1] = tangents[1] + tangents[1].transpose(0, 2, 1)
    return (J, M, b, lo, hi, mu), tangents


def _close_rel(lam, lam_j):
    """lam within 1e-10 of lam_j relative to max(1, |lam_j|)."""
    scale = np.maximum(1.0, np.abs(lam_j))
    close(lam.detach().numpy() / scale, lam_j / scale, atol=1e-10)


def _A(J, M):
    return J @ np.linalg.solve(M, J.transpose(0, 2, 1)) + CFM * np.eye(D)


@pytest.fixture(scope="module")
def dense_ref():
    """case -> JAX (lambda, jvp, vjp wrt A, b, lo, hi, mu), one jitted
    program for the four cases."""
    (J, M, b, lo, hi, mu), (_, _, db, dlo, dhi, dmu) = _problem()
    A = _A(J, M)
    dA = np.random.RandomState(1).randn(B, D, D)
    g = np.random.RandomState(2).randn(B, D)
    fidx = jnp.asarray(FIDX, jnp.int32)

    def run(A, b, lo, hi, mu, dA, db, dlo, dhi, dmu, g):
        out = {}
        for solver, polish in CASES:
            f = jax.vmap(lambda A_, b_, lo_, hi_, mu_: jax_boxed_lcp(A_, b_, lo_, hi_, mu_, fidx, ITERS,
                                                                     solver, polish))
            lam, tan = jax.jvp(f, (A, b, lo, hi, mu), (dA, db, dlo, dhi, dmu))
            out[solver, polish] = (lam, tan, jax.vjp(f, A, b, lo, hi, mu)[1](g))
        return out

    xs = [jnp.asarray(x) for x in (A, b, lo, hi, mu, dA, db, dlo, dhi, dmu, g)]
    return (A, b, lo, hi, mu, dA, db, dlo, dhi, dmu, g), jax.jit(run)(*xs)


@pytest.mark.parametrize("solver,polish", CASES)
def test_boxed_lcp_matches_jax(solver, polish, dense_ref):
    (A, b, lo, hi, mu, dA, db, dlo, dhi, dmu, g), ref = dense_ref
    lam_j, tan_j, vjp_j = ref[solver, polish]
    fidx = torch.tensor(FIDX)
    args = [T(x) for x in (A, b, lo, hi, mu)]
    lam = L.boxed_lcp(*args, fidx, ITERS, solver, polish)
    lam_j = np.asarray(lam_j)
    assert np.isfinite(lam_j).all()
    _close_rel(lam, lam_j)
    with fwAD.dual_level():
        duals = [fwAD.make_dual(x, T(t)) for x, t in zip(args, (dA, db, dlo, dhi, dmu))]
        tan = fwAD.unpack_dual(L.boxed_lcp(*duals, fidx, ITERS, solver, polish)).tangent
    tan_j = np.asarray(tan_j)
    close(tan, tan_j, atol=1e-8 * np.abs(tan_j).max())
    leaves = [x.clone().requires_grad_(True) for x in args]
    got = torch.autograd.grad(L.boxed_lcp(*leaves, fidx, ITERS, solver, polish), leaves, T(g))
    for name, a, w in zip(("A", "b", "lo", "hi", "mu"), got, vjp_j):
        w = np.asarray(w)
        close(a, w, atol=1e-8 * max(np.abs(w).max(), 1e-30), msg=name)


def test_boxed_lcp_given_lambda_runs_no_solve(dense_ref, monkeypatch):
    """With lambda given, BoxedLcp returns it and its vjp is the one after
    the solve, bit for bit; neither sweep runs."""
    (A, b, lo, hi, mu, *_, g), _ = dense_ref
    fidx = torch.tensor(FIDX)
    args = [T(x).requires_grad_(True) for x in (A, b, lo, hi, mu)]
    lam = L.boxed_lcp(*args, fidx, ITERS, "pgs", True)
    want = torch.autograd.grad(lam, args, T(g))
    for name in ("_jacobi", "_pgs", "_polish"):
        monkeypatch.setattr(L, name, None)
    again = L.boxed_lcp(*args, fidx, ITERS, "pgs", True, lam=lam.detach())
    assert torch.equal(again, lam)
    for a, w in zip(torch.autograd.grad(again, args, T(g)), want):
        assert torch.equal(a, w)


@pytest.fixture(scope="module")
def lowrank_ref():
    """JAX (lambda, jvp) of boxed_lcp_lowrank_jvp on the random problem,
    pivot refinement off, one jitted program."""
    (J, M, b, lo, hi, mu), tans = _problem(seed=3)
    dcfm = np.float64(0.7)
    fidx = jnp.asarray(FIDX, jnp.int32)
    cfm = jnp.asarray(CFM)

    def run(J, M, b, lo, hi, mu, dJ, dM, db, dlo, dhi, dmu):
        def f(J, M, c, b, lo, hi, mu):
            return jax.vmap(lambda J_, M_, b_, lo_, hi_, mu_: jax_lowrank_jvp(
                J_, M_, c, b_, lo_, hi_, mu_, fidx, 8, 2, None, 0))(J, M, b, lo, hi, mu)
        return jax.jvp(f, (J, M, cfm, b, lo, hi, mu), (dJ, dM, jnp.asarray(dcfm), db, dlo, dhi, dmu))

    xs = [jnp.asarray(x) for x in (J, M, b, lo, hi, mu, *tans)]
    lam, tan = jax.jit(run)(*xs)
    return (J, M, b, lo, hi, mu), tans, dcfm, np.asarray(lam), np.asarray(tan)


def _lowrank(J, M, cfm, b, lo, hi, mu, lam=None):
    return boxed_lcp_lowrank(J, M, cfm, b, lo, hi, mu, torch.tensor(FIDX), 8, 2, L._jacobi, 0, lam=lam)


def test_lowrank_jvp_matches_jax(lowrank_ref):
    (J, M, b, lo, hi, mu), (dJ, dM, db, dlo, dhi, dmu), dcfm, lam_j, tan_j = lowrank_ref
    primals = [T(J), T(M), torch.tensor(CFM, dtype=torch.float64), *(T(x) for x in (b, lo, hi, mu))]
    tangents = [T(dJ), T(dM), torch.tensor(dcfm), *(T(x) for x in (db, dlo, dhi, dmu))]
    with fwAD.dual_level():
        out = _lowrank(*(fwAD.make_dual(x, t) for x, t in zip(primals, tangents)))
        lam, tan = fwAD.unpack_dual(out)
    _close_rel(lam, lam_j)
    assert np.abs(tan_j).max() > 0
    close(tan, tan_j, atol=1e-8 * np.abs(tan_j).max())
    # dot-product test: <g, J t> against <J^T g, t>, the backward at lam given
    g = T(np.random.RandomState(5).randn(*lam_j.shape))
    leaves = [x.clone().requires_grad_(True) for x in primals]
    vjp = torch.autograd.grad(_lowrank(*leaves, lam=lam.detach()), leaves, g)
    lhs = (g * tan).sum().item()
    rhs = sum((a * t).sum().item() for a, t in zip(vjp, tangents))
    assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), 1.0), (lhs, rhs)
