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
* The host build (a warp's lanes run in turn on scratch filled with NaN)
  against a numpy version of the kernel's serial order (each row's |A| sum
  and dot product over j = 0..D-1, one rounding per multiply and per add),
  bit for bit in float64 and float32: D = 24 (cube), 42 (half-cheetah),
  54 (servo cheetah), 80 (a random problem), rows past one warp in a
  phase (the direct path), and the cap (167 rows in float64, 238 in
  float32, the H100's). The phase lists for friction rows that are not
  contiguous, and the cap itself.
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

from test_torch_vmap_dynamics import MODELS, T, _inputs, batch, close


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


def _np_sweeps(A, b, lo, hi, mu, fidx, iters, dt):
    """The kernel's arithmetic in numpy, in its order and in dt (np.float64,
    or np.float32 with np.float32 scalars): each row's |A| sum and dot
    product in a Python loop over j = 0..D-1 (vectorised over envs and
    rows), one rounding per multiply and per add; the clips with
    torch.maximum / minimum's NaN rule."""
    A, b, lo, hi, mu = (np.asarray(x, dt) for x in (A, b, lo, hi, mu))
    fidx = np.asarray(fidx)
    B, D = b.shape

    def tmax(x, y):
        return np.where(np.isnan(x), x, np.where(np.isnan(y), y, np.where(x > y, x, y)))

    def tmin(x, y):
        return np.where(np.isnan(x), x, np.where(np.isnan(y), y, np.where(x < y, x, y)))

    big = dt(3.4e38)
    lo_s, hi_s = np.where(np.isfinite(lo), lo, -big), np.where(np.isfinite(hi), hi, big)
    rs = np.zeros((B, D), dt)
    for j in range(D):
        rs = rs + np.abs(A[:, :, j])
    d = tmax(np.diagonal(A, axis1=1, axis2=2), dt(1e-12))
    scale = tmin(tmax(d / tmax(rs, dt(1e-12)), dt(0.3)), dt(0.9)) / d
    fr = fidx >= 0
    lam = np.zeros((B, D), dt)
    for _ in range(iters):
        for rows in (~fr, fr):
            r = np.zeros((B, D), dt)
            for j in range(D):
                r = r + A[:, :, j] * lam[:, j:j + 1]
            cand = lam - (r + b) * scale
            lam_f = lam[:, np.where(fr, fidx, 0)]
            new = tmin(tmax(cand, np.where(fr, -mu * lam_f, lo_s)), np.where(fr, mu * lam_f, hi_s))
            lam = np.where(rows, new, lam)
    return lam


@pytest.fixture(scope="module")
def serial_problems():
    """D -> (A, b, lo, hi, mu, fidx, iters) float64 numpy, B = 3: the LCPs
    that prepare_constrained assembles for the cube (D = 24), the
    half-cheetah (42) and the servo cheetah (54) at perturbed states, and
    _wide_problem at D = 80."""
    out = {}
    for name in ("cube_drop", "half_cheetah", "servo_cheetah"):
        m, q0 = MODELS[name](torch.float64, "cpu")
        q, v, tau = (T(x) for x in _inputs(q0, m.nq, m.nv, 3, 2))
        lcp = prepare_constrained(m, State(q=q, v=v), tau)[0]
        xs = [x.numpy() for x in (lcp.A, lcp.b, lcp.lo, lcp.hi, lcp.mu, lcp.fidx)]
        out[xs[1].shape[1]] = (*xs, m.contact_iters)
    *args, fidx = _wide_problem(B=3, D=80, nv=20, seed=3)
    out[80] = (*(x.numpy() for x in args), fidx.numpy(), 6)
    return out


NP_DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}


@pytest.mark.parametrize("dname", sorted(NP_DTYPES))
@pytest.mark.parametrize("D", [24, 42, 54, 80])
def test_host_build_equals_serial_order(D, dname, serial_problems):
    """The host build, the card's per-warp code, bit for bit against the
    numpy serial order: what makes the kernel's λ independent of how rows
    are spread over the lanes."""
    _needs_cxx()
    dt, tdt = NP_DTYPES[dname]
    *xs, fidx, iters = serial_problems[D]
    assert xs[0].shape[-1] == D and np.isinf(xs[3]).any()
    want = _np_sweeps(*xs, fidx, iters, dt)
    got = P.host_sweeps(*(torch.tensor(x.astype(dt)) for x in xs), torch.tensor(fidx), iters, dtype=tdt)
    assert got.dtype == tdt and torch.isfinite(got).all()
    assert torch.equal(got, torch.tensor(want)), (got - torch.tensor(want)).abs().max()
    assert np.abs(want).max() > 0


def _interleaved_fidx(nc, nlim):
    """Contact-major rows (normal, then its two friction rows, per contact)
    and nlim limit rows: friction rows that are not contiguous."""
    f = []
    for c in range(nc):
        f += [-1, 3 * c, 3 * c]
    return np.array(f + [-1] * nlim)


@pytest.mark.parametrize("nc, nlim", [(3, 2), (30, 7)])
def test_phase_lists_for_interleaved_friction_rows(nc, nlim):
    """slot s holds the s-th row with fidx < 0, then the friction rows, each
    in row order, with fidx + 1 above the row; pos inverts it (D = 11 and
    97: one ballot chunk and four)."""
    _needs_cxx()
    fidx = _interleaved_fidx(nc, nlim)
    D = len(fidx)
    f = torch.tensor(fidx)
    slot, pos = torch.full((D,), -7, dtype=torch.int32), torch.full((D,), -7, dtype=torch.int32)
    n0 = P._load("host").jacobi_sweeps_lists(f.data_ptr(), D, slot.data_ptr(), pos.data_ptr())
    rows = np.r_[np.flatnonzero(fidx < 0), np.flatnonzero(fidx >= 0)]
    assert n0 == nc + nlim
    assert (slot.numpy() & 0xFFFF).tolist() == rows.tolist()
    assert ((slot.numpy() >> 16) - 1).tolist() == np.where(fidx[rows] < 0, -1, fidx[rows]).tolist()
    assert pos.numpy()[rows].tolist() == list(range(D))


@pytest.mark.parametrize("D, B", [(9, 5), (33, 4), (70, 3)])
def test_host_build_across_envs_and_warp_chunks(D, B):
    """Interleaved friction rows, B envs one after another on one warp (the
    stage refilled while the register path sweeps, D = 33), and phases of
    more than 32 rows (D = 70: 30 friction rows and 40 others, the direct
    path): no NaN from the poisoned scratch, float64 and float32 bit for bit
    against the serial order."""
    _needs_cxx()
    rng = np.random.default_rng(D)
    nc = D // 3
    fidx = _interleaved_fidx(nc, D - 3 * nc)
    J = rng.normal(size=(B, D, 6))
    A = np.einsum("bik,bjk->bij", J, J) + 1e-3 * np.eye(D)
    hi = np.where(fidx < 0, np.inf, 0.0) * np.ones((B, 1))
    mu = np.where(fidx < 0, 0.0, 0.5) * np.ones((B, 1))
    xs = (A, rng.normal(size=(B, D)), np.zeros((B, D)), hi, mu)
    for dt, tdt in NP_DTYPES.values():
        got = P.host_sweeps(*(torch.tensor(x.astype(dt)) for x in xs), torch.tensor(fidx), 5, dtype=tdt)
        assert torch.isfinite(got).all()
        assert torch.equal(got, torch.tensor(_np_sweeps(*xs, fidx, 5, dt)))


@pytest.mark.parametrize("dname", sorted(NP_DTYPES))
def test_host_build_at_the_cap_takes_the_direct_path(dname):
    """The H100's cap, 167 rows in float64 and 238 in float32, is the first
    version's; there the kernel takes the direct path (b, lo, hi, mu read
    from device memory) and still equals the serial order; at D = 42 only
    float32 can take the register path."""
    _needs_cxx()
    dt, tdt = NP_DTYPES[dname]
    lib = P._load("host")
    cap = {"f64": 167, "f32": 238}[dname]
    elem = np.dtype(dt).itemsize
    assert lib.jacobi_sweeps_max_rows_for(elem, 232448) == cap
    assert not P.launch_config(tdt, cap, kind="host")["register_path"]
    assert P.launch_config(tdt, 42, kind="host")["register_path"] == (dname == "f32")
    assert P.launch_config(tdt, cap, kind="host")["block_bytes"] <= 232448
    args = [x.numpy() for x in _wide_problem(B=2, D=cap, nv=12, seed=cap)]
    got = P.host_sweeps(*(torch.tensor(x.astype(dt)) for x in args[:5]), torch.tensor(args[5]), 3,
                        dtype=tdt)
    assert torch.equal(got, torch.tensor(_np_sweeps(*args, 3, dt)))
