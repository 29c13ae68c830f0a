"""The boxed-LCP sweeps of the torch port: the plain version (ops/lcp.py::
_jacobi) and the wrappers of ops/pallas_lcp.py on the CPU, and the sweep
kernel's per-env code (ops/csrc/jacobi_sweeps.cu) compiled for the host.

* The plain version against jax.vmap of the JAX `_jacobi`, and against the
  TPU kernels themselves in interpret mode (`jacobi_sweeps_pallas`, and
  `jacobi_sweeps_pallas_single` under jax.vmap), on the problem generator of
  tests/test_pallas_lcp.py (B = 16, and its B = 13 padding case) at that
  file's tolerance, atol 1e-6 (tests/test_pallas_lcp.py:41). Float64 inputs
  are the generator's float32 values; the interpret-mode kernel 4
  accumulates its matvec in float32 even for float64 inputs
  (diffdart_tpu/ops/pallas_lcp.py:143-153), which that tolerance covers.
* The host build of the kernel against the plain version on the same
  problems and on real half-cheetah LCPs (D = 42): atol 1e-12, the same
  arithmetic with dot products summed in another order; and on a random
  problem of D = 80 rows (past the first version's cap of 64) within
  ops/sweep_check.py's float64 limit.
* The wrappers' checks: a device that is neither the CPU nor CUDA, shape
  and dtype mismatches raise; CPU calls launch nothing.
"""
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.ops.lcp import _jacobi as jax_jacobi
from diffdart_tpu.ops.pallas_lcp import jacobi_sweeps_pallas as jax_sweeps
from diffdart_tpu.ops.pallas_lcp import jacobi_sweeps_pallas_single as jax_sweeps_single
from diffdart_tpu_torch.ops import pallas_lcp as P
from diffdart_tpu_torch.ops import sweep_check as sc
from diffdart_tpu_torch.ops.lcp import _jacobi
from diffdart_tpu_torch.sim.constrained import prepare_constrained
from diffdart_tpu_torch.dynamics.model import State

from test_torch_vmap_dynamics import T, batch, close


def _problems(B=16, ncon=3, nv=5, seed=0):
    """tests/test_pallas_lcp.py::_problems (float32 values)."""
    rng = np.random.default_rng(seed)
    D = 3 * ncon
    J = rng.normal(size=(B, D, nv)).astype(np.float32)
    A = np.einsum("bik,bjk->bij", J, J) + 1e-3 * np.eye(D, dtype=np.float32)
    b = rng.normal(size=(B, D)).astype(np.float32)
    lo = np.zeros((B, D), np.float32)
    hi = np.concatenate([np.full((B, ncon), np.inf), np.zeros((B, 2 * ncon))], axis=1).astype(np.float32)
    mu = np.concatenate([np.zeros((B, ncon)), np.full((B, 2 * ncon), 0.5)], axis=1).astype(np.float32)
    fidx = tuple(int(x) for x in np.concatenate([np.full(ncon, -1), np.tile(np.arange(ncon), 2)]))
    return A, b, lo, hi, mu, fidx


# (B, seed, iters) of tests/test_pallas_lcp.py
GENERATOR_CASES = {"B16": (16, 0, 6), "B13_padding": (13, 5, 4)}
DTYPES = {"f64": np.float64, "f32": np.float32}


@pytest.fixture(scope="module")
def jax_ref():
    """(case, dtype) -> (inputs, JAX vmap(_jacobi), jacobi_sweeps_pallas and
    vmap(jacobi_sweeps_pallas_single), both in interpret mode)."""
    out = {}
    for case, (B, seed, iters) in GENERATOR_CASES.items():
        for dname, dt in DTYPES.items():
            A, b, lo, hi, mu, fidx = _problems(B=B, seed=seed)
            xs = [x.astype(dt) for x in (A, b, lo, hi, mu)]
            jx = [jnp.asarray(x) for x in xs]
            fj = jnp.asarray(np.array(fidx), jnp.int32)
            ref = jax.jit(jax.vmap(lambda A_, b_, lo_, hi_, mu_: jax_jacobi(A_, b_, lo_, hi_, mu_, fj, iters)))(*jx)
            batched = jax_sweeps(*jx, fidx, iters, interpret=True)
            single = jax.vmap(functools.partial(jax_sweeps_single, fidx=fidx, iters=iters, interpret=True))(*jx)
            out[case, dname] = (xs, fidx, iters, ref, batched, single)
    return out


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(GENERATOR_CASES))
def test_plain_sweeps_match_jax_jacobi(case, dname, jax_ref):
    xs, fidx, iters, ref, _, _ = jax_ref[case, dname]
    got = _jacobi(*(T(x) for x in xs), torch.tensor(fidx), iters)
    assert got.dtype == T(xs[0]).dtype
    close(got, ref, atol=1e-12 if dname == "f64" else 1e-6)


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(GENERATOR_CASES))
def test_wrappers_match_pallas_kernels_interpret(case, dname, jax_ref):
    xs, fidx, iters, _, batched, single = jax_ref[case, dname]
    n0, n1 = P.KERNEL.launches, P.KERNEL_SINGLE.launches
    got = P.jacobi_sweeps_pallas(*(T(x) for x in xs), torch.tensor(fidx), iters)
    got1 = P.jacobi_sweeps_pallas_single(*(T(x) for x in xs), torch.tensor(fidx), iters)
    assert got.shape == (GENERATOR_CASES[case][0], 9)
    close(got, batched, atol=1e-6)
    close(got1, single, atol=1e-6)
    assert (P.KERNEL.launches, P.KERNEL_SINGLE.launches) == (n0, n1), "a CPU call launched"


def _needs_cxx():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")


@pytest.mark.parametrize("case", sorted(GENERATOR_CASES))
def test_host_build_of_kernel_matches_plain(case, jax_ref):
    _needs_cxx()
    xs, fidx, iters, _, _, _ = jax_ref[case, "f64"]
    got = P.host_sweeps(*(T(x) for x in xs), torch.tensor(fidx), iters)
    close(got, _jacobi(*(T(x) for x in xs), torch.tensor(fidx), iters), atol=1e-12)


@pytest.mark.parametrize("name", ["half_cheetah", "servo_cheetah", "cube_drop"])
def test_host_build_on_real_lcps(name):
    """D = 42 (half-cheetah), 54 (servo rows with constant boxes) and 24
    (the cube's 8 corners), iters = contact_iters, with +-inf bounds."""
    _needs_cxx()
    m, _, q, v, tau = batch(name, seed=2)
    lcp = prepare_constrained(m, State(q=T(q), v=T(v)), T(tau))[0]
    args = (lcp.A, lcp.b, lcp.lo, lcp.hi, lcp.mu)
    want = _jacobi(*args, lcp.fidx, m.contact_iters)
    got = P.host_sweeps(*args, lcp.fidx, m.contact_iters)
    assert torch.isinf(lcp.hi).any()
    close(got, want, atol=1e-12)
    assert want.abs().max() > 0


def _wide_problem(B, D, nv, seed):
    """A random boxed LCP of D rows: nc contacts (normal, two friction rows
    each), then D - 3 nc rows with lo = 0, hi = inf (limit rows)."""
    rng = np.random.default_rng(seed)
    nc = D // 3
    J = rng.normal(size=(B, D, nv))
    A = np.einsum("bik,bjk->bij", J, J) + 1e-3 * np.eye(D)
    lo = np.zeros((B, D))
    hi = np.zeros((B, D))
    hi[:, :nc] = np.inf
    hi[:, 3 * nc:] = np.inf
    mu = np.zeros((B, D))
    mu[:, nc:3 * nc] = 0.5
    fidx = np.full(D, -1)
    fidx[nc:3 * nc] = np.tile(np.arange(nc), 2)
    return [T(x) for x in (A, rng.normal(size=(B, D)), lo, hi, mu)] + [torch.tensor(fidx)]


def test_host_build_past_64_rows():
    """D = 80: the kernel's per-env code (which loops its rows over the
    block's threads) against _jacobi within sweep_check's float64 limit."""
    _needs_cxx()
    *args, fidx = _wide_problem(B=3, D=80, nv=20, seed=3)
    got = P.host_sweeps(*args, fidx, 6)
    want = _jacobi(*args, fidx, 6)
    assert sc.sweep_ok(got, want), sc.sweep_error(got, want)
    assert want.abs().max() > 0


def test_wrapper_checks():
    A, b, lo, hi, mu, fidx = _problems(B=4)
    A, b, lo, hi, mu = (T(x.astype(np.float64)) for x in (A, b, lo, hi, mu))
    fidx = torch.tensor(fidx)
    with pytest.raises(ValueError, match="unsupported device"):
        P.jacobi_sweeps_pallas(*(x.to("meta") for x in (A, b, lo, hi, mu, fidx)), 2)
    with pytest.raises(ValueError, match="fidx is on meta"):
        P.jacobi_sweeps_pallas(A, b, lo, hi, mu, fidx.to("meta"), 2)
    with pytest.raises(ValueError, match="b must be"):
        P.jacobi_sweeps_pallas(A, b[:, :5], lo, hi, mu, fidx, 2)
    with pytest.raises(ValueError, match="fidx"):
        P.jacobi_sweeps_pallas_single(A, b, lo, hi, mu, fidx[:5], 2)
    with pytest.raises(ValueError, match="int64"):
        P.jacobi_sweeps_pallas(A, b, lo, hi, mu, fidx.int(), 2)
    with pytest.raises(TypeError, match="float32 or float64"):
        P.jacobi_sweeps_pallas_single(A, b.float(), lo, hi, mu, fidx, 2)
