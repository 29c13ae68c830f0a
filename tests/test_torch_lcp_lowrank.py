"""The low-rank boxed LCP of the torch port (ops/lcp_lowrank.py,
ops/lcp_pivot.py) against the JAX package, float64 on the CPU, on real LCPs
that the port's prepare_constrained assembles at half-cheetah, servo
cheetah and cube_drop states (the same numbers go to both packages).

* lambda of _solve_impl (sweeps, two polish passes, pivot) against
  jax.vmap of the JAX _solve_impl: atol 1e-8 on envs whose LCP converged
  (natural-map residual below 1e-8, the JAX package's own criterion,
  tests/test_tilestep.py:103-126). The Woodbury solve amplifies the
  rounding of another summation order by about eps/cfm = 2.2e-10 relative,
  on impulses of up to ~10 (measured: 2.7e-9 at most).
* The VJP of boxed_lcp_lowrank (the autograd.Function whose backward is the
  transposed IFT tangent map) against jax.vjp of the JAX custom_vjp, with
  respect to J, M, b, lo, hi and mu, on converged envs: rtol 1e-6 plus atol
  1e-8 times the largest magnitude of each cotangent, the limits of
  diffdart_tpu_torch/ops/vjp_check.py (another summation order, amplified
  by about eps/cfm).
* pivot_refine on cube_drop (8 redundant corners per cube, where the
  polish alone stalls): the refined lambda against the JAX package's on
  every env, and the refinement never raises a residual. The pivot also
  runs in the lambda and VJP checks (the models' default 16 iterations).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.ops.lcp import _nat_residual as jax_nat_residual
from diffdart_tpu.ops.lcp_lowrank import boxed_lcp_lowrank as jax_boxed_lcp_lowrank
from diffdart_tpu_torch.dynamics.model import State
from diffdart_tpu_torch.ops.lcp import _jacobi, _nat_residual
from diffdart_tpu_torch.ops.lcp_lowrank import _solve_impl, boxed_lcp_lowrank
from diffdart_tpu_torch.ops.vjp_check import VJP_ATOL, VJP_RTOL
from diffdart_tpu_torch.sim.constrained import prepare_constrained

from test_torch_vmap_dynamics import MODELS, T, close

B = 16
CASES = ["half_cheetah", "servo_cheetah", "cube_drop"]
DIFF = ("J", "M", "b", "lo", "hi", "mu")


# name -> root height change from MODELS' q0: the half-cheetah 0.1 above
# MODELS' (0.15 below standing; six contacts per env, none converged by the
# polish alone, all by the pivot), the servo cheetah 0.1 below (eight
# contacts, constant-box rows); the cube as it is
LIFT = {"half_cheetah": 0.1, "servo_cheetah": -0.1, "cube_drop": 0.0}


def _lcp(name, seed=3):
    """The port's LCP at a batch of contact states (q0 + 0.02 N, v 0.05 N,
    tau 0.1 N), as numpy (B, ...)."""
    m, q0 = MODELS[name](torch.float64, "cpu")
    rng = np.random.RandomState(seed)
    q = np.tile(q0, (B, 1)) + 0.02 * rng.randn(B, m.nq)
    q[:, 0] += LIFT[name]
    v, tau = 0.05 * rng.randn(B, m.nv), 0.1 * rng.randn(B, m.nv)
    lcp, M, _, _, _ = prepare_constrained(m, State(q=T(q), v=T(v)), T(tau))
    arrs = dict(J=lcp.J, M=M, b=lcp.b, lo=lcp.lo, hi=lcp.hi, mu=lcp.mu, A=lcp.A)
    return m, {k: x.numpy() for k, x in arrs.items()}, lcp.fidx.numpy()


def lcp_references():
    """name -> (model, numpy LCP, fidx, JAX lam (with the pivot refinement),
    its residuals, cotangent g, JAX VJP), from one jitted program per model,
    computed once (scripts/torch_vmap_parity.py uses it too)."""
    cache = {}

    def get(name):
        if name not in cache:
            m, x, fidx = _lcp(name)
            cfm = jnp.asarray(m.contact_cfm)
            fj = jnp.broadcast_to(jnp.asarray(fidx, jnp.int32), x["b"].shape)
            g = np.random.RandomState(4).randn(*x["b"].shape)

            def f(J, M, b, lo, hi, mu):
                return jax.vmap(lambda J_, M_, b_, lo_, hi_, mu_, f_: jax_boxed_lcp_lowrank(
                    J_, M_, cfm, b_, lo_, hi_, mu_, f_, m.contact_iters, 2, None,
                    m.lcp_pivot_iters))(J, M, b, lo, hi, mu, fj)

            def run(xs, A, g):
                lam, vjp = jax.vjp(f, *xs)
                return lam, jax.vmap(jax_nat_residual)(lam, A, *xs[2:], fj), vjp(g)

            lam, res, vjp = jax.jit(run)([jnp.asarray(x[k]) for k in DIFF], jnp.asarray(x["A"]),
                                         jnp.asarray(g))
            cache[name] = (m, x, fidx, np.asarray(lam), np.asarray(res), g, vjp)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def ref():
    return lcp_references()


def _port_inputs(x, requires_grad=False):
    return [T(x[k]).requires_grad_(requires_grad) for k in DIFF]


def _solve(m, x, fidx, pivot_iters):
    J, M, b, lo, hi, mu = _port_inputs(x)
    cfm = torch.tensor(m.contact_cfm, dtype=torch.float64)
    f = torch.tensor(fidx)
    lam = _solve_impl(J, M, cfm, b, lo, hi, mu, f, m.contact_iters, 2, _jacobi, pivot_iters)
    return lam, _nat_residual(lam, T(x["A"]), b, lo, hi, mu, f).numpy()


@pytest.mark.parametrize("name", CASES)
def test_lambda_matches_jax(name, ref):
    m, x, fidx, lam_j, res_j, _, _ = ref(name)
    lam, res = _solve(m, x, fidx, m.lcp_pivot_iters)
    conv = res_j < 1e-8
    assert conv.sum() >= B * 3 // 4, f"too few converged envs: {conv.sum()} of {B}"
    close(lam[conv], lam_j[conv], atol=1e-8)
    assert (res[conv] < 1e-8).all()


@pytest.mark.parametrize("name", CASES)
def test_vjp_matches_jax(name, ref):
    m, x, fidx, _, res_j, g, want = ref(name)
    xs = _port_inputs(x, requires_grad=True)
    cfm = torch.tensor(m.contact_cfm, dtype=torch.float64)
    lam = boxed_lcp_lowrank(xs[0], xs[1], cfm, *xs[2:], torch.tensor(fidx), m.contact_iters, 2,
                            _jacobi, m.lcp_pivot_iters)
    got = torch.autograd.grad(lam, xs, T(g))
    conv = res_j < 1e-8
    for name_k, a, w in zip(DIFF, got, want):
        a, w = a.numpy()[conv], np.asarray(w)[conv]
        assert np.isfinite(a).all()
        tol = VJP_RTOL * np.abs(w) + VJP_ATOL * np.abs(w).max()
        assert (np.abs(a - w) <= tol).all(), (name_k, np.abs(a - w).max(), np.abs(w).max())
    assert np.abs(np.asarray(want[0])[conv]).max() > 0


def test_vjp_with_cfm_and_unused_inputs():
    """Only the inputs that require grad get a tangent leaf; cfm's gradient
    is the IFT derivative (checked against a central difference)."""
    m, x, fidx = _lcp("half_cheetah")
    J, M, b, lo, hi, mu = _port_inputs(x)
    f = torch.tensor(fidx)
    cfm = torch.tensor(m.contact_cfm, dtype=torch.float64, requires_grad=True)
    b.requires_grad_(True)
    g = T(np.random.RandomState(5).randn(*x["b"].shape))
    lam = boxed_lcp_lowrank(J, M, cfm, b, lo, hi, mu, f, m.contact_iters, 2, _jacobi, 0)
    dcfm, db = torch.autograd.grad(lam, (cfm, b), g)
    assert torch.isfinite(dcfm) and torch.isfinite(db).all()
    res = _nat_residual(lam.detach(), T(x["A"]), b.detach(), lo, hi, mu, f)
    conv = res < 1e-8
    eps = 1e-9
    with torch.no_grad():
        lp, lm = (boxed_lcp_lowrank(J, M, cfm + s, b, lo, hi, mu, f, m.contact_iters, 2, _jacobi, 0)
                  for s in (eps, -eps))
    fd = ((lp - lm) / (2 * eps) * g)[conv].sum()
    cfm2 = cfm.detach().clone().requires_grad_(True)
    lam2 = boxed_lcp_lowrank(J, M, cfm2, b.detach(), lo, hi, mu, f, m.contact_iters, 2, _jacobi, 0)
    (d_conv,) = torch.autograd.grad((lam2 * g)[conv].sum(), cfm2)
    # step 1e-9 on cfm = 1e-6: the 1/cfm amplification of rounding in lam
    # limits the difference quotient to ~1e-4 relative
    np.testing.assert_allclose(d_conv.item(), fd.item(), rtol=1e-3)


def test_pivot_refine_on_cube_drop(ref):
    m, x, fidx, lam_j, res_j, _, _ = ref("cube_drop")
    _, r0 = _solve(m, x, fidx, 0)
    lam, res = _solve(m, x, fidx, 16)
    touched = res < r0 - 1e-12
    assert touched.any(), "the pivot refinement changed no env on these states"
    assert (res <= r0 + 1e-12).all()
    close(lam, lam_j, atol=1e-8)
    assert ((res < 1e-8) == (res_j < 1e-8)).all()
