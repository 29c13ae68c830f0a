"""The port's binding of the native Dantzig pivot solver
(diffdart_tpu_torch/ops/native_lcp.py, built from native/lcp_dantzig.cpp
into diffdart_tpu_torch/_build/) against the JAX package's binding of the
same source, float64 on the CPU, on tests/test_native_lcp.py's random
contact problems: the two solutions, w and status are equal bit for bit.
The port's dense solver (ops/lcp.py::boxed_lcp, 'pgs', 60 sweeps, polish)
and its low-rank solver (ops/lcp_lowrank.py, 20 sweeps, 4 passes) are
within 2e-5 of the pivot solution wherever it is exact, as the JAX
package's are there.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from diffdart_tpu.ops import native_lcp as jax_native
from diffdart_tpu_torch.ops import _build
from diffdart_tpu_torch.ops import native_lcp
from diffdart_tpu_torch.ops.lcp import boxed_lcp
from diffdart_tpu_torch.ops.lcp_lowrank import boxed_lcp_lowrank

from test_native_lcp import _rand_contact_problem


@pytest.fixture(scope="module")
def port_built():
    """Skips only where no host C++ compiler is present; otherwise builds
    the port's library, so that a build or link error fails the tests."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    native_lcp._load()


@pytest.fixture(scope="module")
def built(port_built):
    if not jax_native.available():
        pytest.skip("the JAX package's native library does not build")


@pytest.mark.parametrize("seed", range(6))
def test_solutions_equal_the_jax_binding(built, seed):
    A, b, lo, hi, mu, fidx, _, _ = _rand_contact_problem(seed)
    x, w, st = native_lcp.boxed_lcp_dantzig(A, b, lo, hi, mu, fidx)
    jx, jw, jst = jax_native.boxed_lcp_dantzig(A, b, lo, hi, mu, fidx)
    assert st == jst
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(w, jw)


def test_batched_solvers_within_the_pivot_solution(port_built):
    exact = 0
    for seed in range(4):
        A, b, lo, hi, mu, fidx, J, M = _rand_contact_problem(seed)
        x_native, _, st = native_lcp.boxed_lcp_dantzig(A, b, lo, hi, mu, fidx)
        if st != 0:  # a degenerate coupled problem: no unique answer
            continue
        exact += 1
        T = lambda x: torch.tensor(np.asarray(x, np.float64))[None]  # noqa: E731
        hi_t = torch.where(T(hi) > 1e29, torch.full_like(T(hi), float("inf")), T(hi))
        fidx_t = torch.tensor(fidx, dtype=torch.long)
        with torch.no_grad():
            x_pgs = boxed_lcp(T(A), T(b), T(lo), hi_t, T(mu), fidx_t, 60, "pgs", True)
            cfm = torch.tensor(1e-3 * float(np.trace(A)) / len(b), dtype=torch.float64)
            x_low = boxed_lcp_lowrank(T(J), T(M), cfm, T(b), T(lo), hi_t, T(mu), fidx_t, 20, 4)
        np.testing.assert_allclose(x_pgs[0].numpy(), x_native, atol=2e-5)
        np.testing.assert_allclose(x_low[0].numpy(), x_native, atol=2e-5)
    assert exact >= 3


def test_builds_into_the_package_build_directory(port_built):
    """The library sits in diffdart_tpu_torch/_build/ under a name keyed by
    the source; nothing is written into native/ by this binding."""
    lib = native_lcp._load()
    assert os.path.dirname(lib._name) == str(_build.BUILD_DIR)
    assert os.path.basename(lib._name).startswith("liblcp_dantzig_host_")
    with pytest.raises(ValueError, match="A must be"):
        native_lcp.boxed_lcp_dantzig(np.eye(2), np.zeros(3), np.zeros(3), np.ones(3), np.zeros(3),
                                     -np.ones(3))
