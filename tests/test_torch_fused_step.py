"""ops/fused_step.py and sim/fast.py of the torch port.

* One step of the port's fused step on the worm at B = 1024 against the
  TPU kernel itself, build_pallas_step(interpret=True) of the JAX package;
  the host build of the VJP kernel against that kernel's VJP (the Pallas
  `_bwd_kernel` in interpret mode).
* The CUDA kernels' per-env code, compiled for the host CPU, against the
  plain PyTorch version (float64, every model of KERNEL_MODELS): the step's
  output, and the VJP (reverse mode on a tape) against torch.autograd.grad
  through the plain version and against its forward-mode AD; the tape's
  primal against the step; the tape's node count (the same in every env)
  and its overflow, which raises. The kernels' arithmetic is checked here
  although the kernels themselves run only on a card.
* The step kernel's warp: its host build runs the warp's 32 lanes one after
  another, phase by phase, so the lane partition of the LCP solve is the
  card's. Its output equals the VJP recording's primal (the serial solve)
  bit for bit, in float64 and float32, for every model of KERNEL_MODELS,
  which between them make the lanes wrap (D > 32) and leave lanes idle
  (D < 32); the launch that stops after the front end returns v*.
* The VJP at the step kernel's saved LCP solution (the warp solve's `best`
  and residual, which the CUDA path's forward writes for its backward)
  equals the VJP that solves the LCP itself (the serial solve) bit for bit;
  the VJP reads that buffer: one element changed moves its env's gradient.
* FusedStepFn (the autograd.Function of the CUDA path) over a short BPTT
  rollout, with the host builds as its launchers (the solution passed from
  the forward to the backward), against plain autograd.
* rollout_fast on the CPU against a loop over the plain version; the cache
  of one FusedStep per model; its fallback reason on CUDA for a model over
  the kernel's caps.
* What must raise: models outside the fused subset or the kernel's subset,
  inputs on a device that is neither the CPU nor CUDA.
* The port imports neither jax nor the JAX package.

Gradient tolerance: diffdart_tpu_torch/ops/vjp_check.py (rtol 1e-6 plus atol
1e-8 times each array's largest magnitude, on >= 99% of envs), which says
why. At atol 1e-10 times the largest magnitude only 79.69% of
servo_cheetah's envs pass against reverse mode; at 1e-8 all envs of every
model do (scripts/torch_port_parity.py).
"""
import gc
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.models import jump_worm as jax_jump_worm
from diffdart_tpu.ops.pallas_step import build_pallas_step, from_tiles, to_tiles
from diffdart_tpu_torch.dynamics.model import GeomType, JointType, ModelBuilder, State
from diffdart_tpu_torch.models import half_cheetah, jump_worm
from diffdart_tpu_torch.ops import fused_step as fs
from diffdart_tpu_torch.ops.fused_step import host_kernel_step, host_kernel_vjp
from diffdart_tpu_torch.ops.vjp_check import VJP_ATOL, VJP_RTOL, VJP_SHARE, envs_within, forward_mode_vjp
from diffdart_tpu_torch.sim import fast
from diffdart_tpu_torch.sim.fast import rollout_fast, supports_fused
from diffdart_tpu_torch.sim.tilestep import TileStepUnsupported, build_tile_step

from test_torch_cuda import KERNEL_MODELS, WORM_Q0
from test_torch_cuda import inputs as _inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _needs_cxx():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")


def _soa(x, **kw):
    return torch.tensor(np.ascontiguousarray(x.T), **kw)


def _worm(**kw):
    return jump_worm(dt=2e-3, n_links=2, dtype=torch.float64, device="cpu", **kw)


def test_fused_step_matches_pallas_kernel_interpret():
    """Port vs the TPU kernel (interpret mode) on one (8, 128) block. The
    interpret-mode kernel is an XLA:CPU program, whose rounding differs from
    op-by-op evaluation by up to ~1e-7 relative after the eps/cfm
    amplification of the Woodbury polish (2.7e-7 absolute at |v| = 13 on 4
    of these 4096 values), hence the relative term on v."""
    jm = jax_jump_worm(dt=2e-3, n_links=2).replace(lcp_pivot_iters=0)
    m = _worm()
    q, v, tau = _inputs(WORM_Q0, m.nq, m.nv, B=1024, seed=1)
    qj, vj = build_pallas_step(jm, interpret=True)(
        *(to_tiles(jnp.asarray(x)) for x in (q, v, tau)))
    with torch.no_grad():
        qt, vt = fs.build_fused_step(m)(_soa(q), _soa(v), _soa(tau))
    np.testing.assert_allclose(qt.T.numpy(), np.asarray(from_tiles(qj)), atol=1e-8, rtol=0)
    np.testing.assert_allclose(vt.T.numpy(), np.asarray(from_tiles(vj)), atol=1e-7, rtol=1e-7)


@pytest.mark.parametrize("model", sorted(KERNEL_MODELS))
def test_host_build_of_kernel_matches_plain_version(model):
    _needs_cxx()
    m, q0 = KERNEL_MODELS[model](torch.float64, "cpu")
    q, v, tau = (_soa(x) for x in _inputs(q0, m.nq, m.nv, B=64, seed=2))
    with torch.no_grad():
        qp, vp = build_tile_step(m)(q, v, tau)
    qk, vk = host_kernel_step(m, q, v, tau)
    np.testing.assert_allclose(qk.numpy(), qp.numpy(), atol=1e-8, rtol=0)
    np.testing.assert_allclose(vk.numpy(), vp.numpy(), atol=1e-7, rtol=0)


@pytest.mark.parametrize("polish", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model", sorted(KERNEL_MODELS))
def test_host_step_kernel_warp_equals_serial_solve(model, dtype, polish):
    """The step kernel's host build (the warp's LCP solve, its 32 lanes run
    in turn) equals the VJP recording's primal (the same stages with the
    serial solve) bit for bit. Without the Woodbury polish, which would
    repair a rounding slip of the sweeps on the rows it solves, the output
    is the sweeps' own."""
    _needs_cxx()
    m, q0 = KERNEL_MODELS[model](torch.float64, "cpu")
    m = m.replace(lcp_polish=polish)
    q, v, tau, gq, gv = _vjp_inputs(m, q0, B=48, seed=12)
    qk, vk = host_kernel_step(m, q, v, tau, dtype=dtype)
    _, (qo, vo), _ = host_kernel_vjp(m, q, v, tau, gq, gv, dtype=dtype)
    assert qk.dtype == dtype and torch.isfinite(qk).all() and torch.isfinite(vk).all()
    assert torch.equal(qk, qo) and torch.equal(vk, vo)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model", ["worm", "half_cheetah", "octahedron"])
def test_host_vjp_at_saved_solution_equals_self_solved(model, dtype):
    """The VJP given kernel 1's saved LCP solution (its host build, the warp
    solve) returns dq, dv, dtau and the primal bit for bit as the VJP that
    solves the LCP itself (the serial solve), for every env; every element
    of the solution was written. One element changed in the solution
    changes that env's gradient: the VJP reads the buffer."""
    _needs_cxx()
    m, q0 = KERNEL_MODELS[model](torch.float64, "cpu")
    q, v, tau, gq, gv = _vjp_inputs(m, q0, B=24, seed=16)
    qk, vk, sol = host_kernel_step(m, q, v, tau, dtype=dtype, solution=True)
    D = fs.build_fused_step(m).D
    assert sol.shape == (24, D + 1) and sol.dtype == dtype and torch.isfinite(sol).all()
    got, (qo, vo), n_got = host_kernel_vjp(m, q, v, tau, gq, gv, dtype=dtype, solution=sol)
    want, _, n_want = host_kernel_vjp(m, q, v, tau, gq, gv, dtype=dtype)
    assert n_got == n_want and all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(qo, qk) and torch.equal(vo, vk)
    e, i = divmod(int(sol[:, :D].abs().argmax()), D)  # the largest impulse: an active row
    bad = sol.clone()
    bad[e, i] = bad[e, i] * 1.5 + 0.1
    moved = host_kernel_vjp(m, q, v, tau, gq, gv, dtype=dtype, solution=bad)[0]
    assert any(not torch.equal(a[:, e], b[:, e]) for a, b in zip(moved, want))
    others = [k for k in range(24) if k != e]
    assert all(torch.equal(a[:, others], b[:, others]) for a, b in zip(moved, want))


@pytest.mark.parametrize("extra", [-1, 1])
def test_host_vjp_refuses_a_solution_of_another_width(extra):
    """The VJP holds the solution's rows to the descriptor's D + 1 values:
    a row narrower or wider than kernel 1 writes is refused (the card's
    build traps), never read past."""
    _needs_cxx()
    m = _worm()
    q, v, tau, gq, gv = _vjp_inputs(m, WORM_Q0, B=4, seed=9)
    other = torch.zeros(4, fs.build_fused_step(m).D + 1 + extra, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="host fused_step_vjp failed"):
        host_kernel_vjp(m, q, v, tau, gq, gv, solution=other)


def test_kernel_models_wrap_and_idle_the_lanes():
    """KERNEL_MODELS holds LCPs of more rows than a warp has lanes (each
    lane then takes several rows) and of fewer (lanes idle), and the step
    kernel's shared memory per env grows with the model's D and nv."""
    rows = {name: fs.build_fused_step(KERNEL_MODELS[name](torch.float64, "cpu")[0]).D
            for name in KERNEL_MODELS}
    assert rows["half_cheetah"] == 42 and max(rows.values()) > 32 and min(rows.values()) < 32
    _needs_cxx()
    small, large = (fs.occupancy("host", torch.float32, D, nv) for D, nv in ((5, 5), (42, 9)))
    caps = fs.occupancy("host", torch.float64, fs.MAX_D, fs.MAX_NV)
    assert small["env_bytes"] < large["env_bytes"] < caps["env_bytes"] <= 48 * 1024
    assert large["env_bytes"] % 16 == 0 and large["warps_per_sm"] == 0


def test_front_only_launch_returns_v_star():
    """The launch that stops after the front end returns v* and no q': on a
    chain without contacts or limits (no LCP rows) v* is the step's v'."""
    _needs_cxx()
    b = ModelBuilder(dt=2e-3)
    prev = -1
    for _ in range(3):
        prev = b.add_body(parent=prev, jtype=JointType.REVOLUTE, axis=(0, 1, 0), X_pos=(0, 0, -0.2),
                          damping=0.1)
    chain = b.finalize(dtype=torch.float64, device="cpu")
    q, v, tau = (_soa(x) for x in _inputs(np.array([0.3, -0.2, 0.1]), 3, 3, B=8, seed=13))
    for dtype in (torch.float64, torch.float32):
        q1, v1 = host_kernel_step(chain, q, v, tau, dtype=dtype)
        none, vstar = host_kernel_step(chain, q, v, tau, dtype=dtype, front_only=True)
        assert fs.build_fused_step(chain).D == 0 and none is None and torch.equal(vstar, v1)
    m, q0 = KERNEL_MODELS["worm"](torch.float64, "cpu")
    q, v, tau = (_soa(x) for x in _inputs(q0, m.nq, m.nv, B=8, seed=14))
    _, vstar = host_kernel_step(m, q, v, tau, front_only=True)
    assert torch.isfinite(vstar).all() and not torch.equal(vstar, host_kernel_step(m, q, v, tau)[1])


def _vjp_inputs(m, q0, B, seed):
    q, v, tau = (_soa(x) for x in _inputs(q0, m.nq, m.nv, B=B, seed=seed))
    rng = np.random.RandomState(seed + 100)
    return q, v, tau, torch.tensor(rng.randn(m.nq, B)), torch.tensor(rng.randn(m.nv, B))


@pytest.mark.parametrize("model", sorted(KERNEL_MODELS))
def test_host_vjp_matches_plain_autograd(model):
    _needs_cxx()
    m, q0 = KERNEL_MODELS[model](torch.float64, "cpu")
    q, v, tau, gq, gv = _vjp_inputs(m, q0, B=64, seed=2)
    xs = [x.clone().requires_grad_(True) for x in (q, v, tau)]
    want = torch.autograd.grad(build_tile_step(m)(*xs), xs, (gq, gv))
    got = host_kernel_vjp(m, q, v, tau, gq, gv)[0]
    assert all(torch.isfinite(x).all() for x in got)
    assert envs_within(got, want) >= VJP_SHARE


@pytest.mark.parametrize("model", sorted(KERNEL_MODELS))
def test_host_vjp_matches_plain_forward_mode(model):
    """The host build against forward-mode AD of the plain version, the
    other mode, in float64 at the float64 tolerance (chip_smoke.py prints
    it beside the float32 check against reverse mode)."""
    _needs_cxx()
    m, q0 = KERNEL_MODELS[model](torch.float64, "cpu")
    q, v, tau, gq, gv = _vjp_inputs(m, q0, B=16, seed=6)
    want = forward_mode_vjp(build_tile_step(m), q, v, tau, gq, gv)
    got = host_kernel_vjp(m, q, v, tau, gq, gv)[0]
    assert envs_within(got, want) >= VJP_SHARE
    assert envs_within([torch.zeros_like(x) for x in got], want) == 0.0


@pytest.mark.parametrize("model", sorted(KERNEL_MODELS))
def test_host_vjp_primal_equals_host_step(model):
    """The primal that the tape records is kernel 1's output, bit for bit."""
    _needs_cxx()
    m, q0 = KERNEL_MODELS[model](torch.float64, "cpu")
    q, v, tau, gq, gv = _vjp_inputs(m, q0, B=32, seed=3)
    _, (qo, vo), _ = host_kernel_vjp(m, q, v, tau, gq, gv)
    qk, vk = host_kernel_step(m, q, v, tau)
    assert torch.equal(qo, qk) and torch.equal(vo, vk)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model", sorted(KERNEL_MODELS))
def test_tape_node_count_is_the_same_in_every_env(model, dtype):
    """Every env of a model records the same number of nodes: a tape of
    exactly the count of the first env of one input set holds every env of
    another, and the count does not move with the inputs."""
    _needs_cxx()
    m, q0 = KERNEL_MODELS[model](torch.float64, "cpu")
    n1 = host_kernel_vjp(m, *_vjp_inputs(m, q0, B=1, seed=4), dtype=dtype)[2]
    (dq, dv, dtau), _, n2 = host_kernel_vjp(m, *_vjp_inputs(m, q0, B=16, seed=5), cap=n1, dtype=dtype)
    assert n1 == n2 > m.nq + 2 * m.nv
    assert all(torch.isfinite(x).all() for x in (dq, dv, dtau))


def test_tape_overflow_raises():
    """A tape one node short of what an env records raises, with no result;
    the exact count suffices."""
    _needs_cxx()
    m = _worm()
    q, v, tau, gq, gv = _vjp_inputs(m, WORM_Q0, B=8, seed=7)
    nodes = host_kernel_vjp(m, q, v, tau, gq, gv)[2]
    with pytest.raises(RuntimeError, match=f"tape overflow: an env records {nodes} nodes, the tape holds {nodes - 1}"):
        host_kernel_vjp(m, q, v, tau, gq, gv, cap=nodes - 1)
    got = host_kernel_vjp(m, q, v, tau, gq, gv, cap=nodes)[0]
    assert all(torch.isfinite(x).all() for x in got)
    assert fs.tape_bytes(torch.float32, nodes, 4096) == nodes * 4096 * 20
    assert fs.tape_bytes(torch.float64, nodes, 2) == nodes * 2 * 32


def test_tape_status_is_read_once_per_pass():
    """The VJP launches of one backward pass share one TapeStatus: every
    launch gets the same zeroed tensor, the check raises with the counts
    when a launch flagged an overflow, and the next pass starts from zero."""
    st = fs.TapeStatus()
    t = st.take(torch.device("cpu"), 10)
    assert t is st.take(torch.device("cpu"), 10) and t.tolist() == [0, 0]
    t.copy_(torch.tensor([12, 1], dtype=torch.int32))
    with pytest.raises(RuntimeError, match="tape overflow: an env records 12 nodes, the tape holds 10"):
        st.check()
    assert st.tensor is None
    st.check()
    assert st.take(torch.device("cpu"), 10).tolist() == [0, 0]


def test_record_only_launch_writes_no_gradient():
    """With dq null the VJP launch records the tape (the primal step and
    the node count) and stops: the gradient buffers stay as they were."""
    _needs_cxx()
    m = _worm()
    q, v, tau, gq, gv = (np.ascontiguousarray(x.numpy()) for x in _vjp_inputs(m, WORM_Q0, B=4, seed=8))
    di, df = fs.pack_descriptor(m)
    (_, _, _), (q1, v1), nodes = host_kernel_vjp(m, *(torch.from_numpy(x) for x in (q, v, tau, gq, gv)))
    cap = fs.tape_capacity(nodes)
    tape = np.empty(fs.tape_bytes(torch.float64, cap, 4), np.uint8)
    status = np.zeros(2, np.int32)
    dv, dtau = np.full_like(v, 7.0), np.full_like(tau, 7.0)
    qo, vo = np.empty_like(q), np.empty_like(v)
    err = fs._load("host").fused_step_vjp_f64(
        *(a.ctypes.data for a in (di, df, q, v, tau)), None,
        *(a.ctypes.data for a in (gq, gv)), None,
        *(a.ctypes.data for a in (dv, dtau, qo, vo, tape, status)), 4, cap, 0, None)
    assert err == 0 and status.tolist() == [nodes, 0]
    assert np.array_equal(qo, q1.numpy()) and np.array_equal(vo, v1.numpy())
    assert (dv == 7.0).all() and (dtau == 7.0).all()


def test_host_vjp_matches_pallas_bwd_kernel_interpret():
    """The VJP kernel's host build against the TPU's `_bwd_kernel` in
    interpret mode (jax.vjp of build_pallas_step), worm, B = 1024. On 1 of
    these 1024 envs (env 374) the interpret-mode program's VJP differs from
    the kernel's by 4.5e-3 relative, where the eager JAX tile step's VJP and
    the port's plain autograd agree with the kernel to 4.9e-9
    (scripts/torch_port_parity.py): XLA:CPU's rounding, amplified at an
    active-set tolerance. The >= 99% rule of the VJP tolerance covers it."""
    _needs_cxx()
    jm = jax_jump_worm(dt=2e-3, n_links=2).replace(lcp_pivot_iters=0)
    m = _worm()
    B = 1024
    q, v, tau = _inputs(WORM_Q0, m.nq, m.nv, B=B, seed=1)
    rng = np.random.RandomState(11)
    gq, gv = rng.randn(B, m.nq), rng.randn(B, m.nv)
    _, vjp = jax.vjp(build_pallas_step(jm, interpret=True),
                     *(to_tiles(jnp.asarray(x)) for x in (q, v, tau)))
    want = [torch.tensor(np.asarray(from_tiles(x)).T)
            for x in vjp((to_tiles(jnp.asarray(gq)), to_tiles(jnp.asarray(gv))))]
    got = host_kernel_vjp(m, *(_soa(x) for x in (q, v, tau, gq, gv)))[0]
    assert all(torch.isfinite(x).all() for x in got)
    assert envs_within(got, want) >= VJP_SHARE


def test_fused_step_fn_bptt_with_host_launchers():
    """FusedStepFn, the autograd.Function that the CUDA path runs, over a
    3-step worm BPTT with the host builds of both kernels as its launchers,
    the step's detached LCP solution passed from the forward to the VJP:
    the benchmark loss's gradient wrt the control tape against make_bench_fns'
    grad, which on CPU tensors is plain autograd."""
    _needs_cxx()
    m = _worm()
    B, T = 16, 3
    q, v, _ = (_soa(x) for x in _inputs(WORM_Q0, m.nq, m.nv, B=B, seed=4))
    taus = torch.tensor(0.3 * np.random.RandomState(5).randn(T, m.nv, B), requires_grad=True)

    def launch(q, v, tau):
        return host_kernel_step(m, q, v, tau, solution=True)

    def launch_vjp(q, v, tau, solution, gq, gv):
        return host_kernel_vjp(m, q, v, tau, gq, gv, solution=solution)[0]

    qc, vc = q, v
    for t in range(T):
        qc, vc = fs.FusedStepFn.apply(launch, launch_vjp, qc, vc, taus[t])
    loss = (qc[1] ** 2).mean() + 1e-4 * (taus**2).mean()
    (got,) = torch.autograd.grad(loss, taus)
    want = fs.make_bench_fns(m)[1](q, v, taus)
    assert torch.isfinite(got).all() and got.abs().sum() > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=VJP_RTOL,
                               atol=VJP_ATOL * want.abs().max().item())


def test_rollout_fast_cpu_matches_plain_loop():
    m = _worm()
    B, T = 8, 6
    q, v, _ = _inputs(WORM_Q0, m.nq, m.nv, B=B, seed=3)
    taus = 0.1 * np.random.RandomState(4).randn(T, B, m.nv)
    state = State(q=torch.tensor(q), v=torch.tensor(v), t=torch.zeros(B, dtype=torch.float64))
    with torch.no_grad():
        out = rollout_fast(m, state, torch.tensor(taus))
        step = build_tile_step(m)
        qs, vs = _soa(q), _soa(v)
        for t in range(T):
            qs, vs = step(qs, vs, _soa(taus[t]))
    np.testing.assert_array_equal(out.q.numpy(), qs.T.numpy())
    np.testing.assert_array_equal(out.v.numpy(), vs.T.numpy())
    np.testing.assert_allclose(out.t.numpy(), T * 2e-3)


def test_rollout_fast_cpu_gradient_flows():
    m = _worm()
    q, v, tau = _inputs(WORM_Q0, m.nq, m.nv, B=4, seed=5)
    taus = torch.tensor(np.tile(tau[None], (3, 1, 1)) * 0.3, requires_grad=True)
    out = rollout_fast(m, State(q=torch.tensor(q), v=torch.tensor(v)), taus)
    (out.q**2).sum().backward()
    assert torch.isfinite(taus.grad).all() and taus.grad.abs().sum() > 0


def test_soa_round_trip():
    x = torch.arange(12.0).reshape(4, 3)
    assert fs.to_soa(x).shape == (3, 4) and fs.to_soa(x).is_contiguous()
    assert torch.equal(fs.from_soa(fs.to_soa(x)), x)


def test_unsupported_models_raise():
    b = ModelBuilder(dt=1e-3)
    b.add_body(parent=-1, jtype=JointType.UNIVERSAL)
    universal = b.finalize(dtype=torch.float64, device="cpu")
    with pytest.raises(TileStepUnsupported):
        fs.build_fused_step(universal)
    assert not supports_fused(universal)
    # outside the fused subset: rollout_fast warns and falls back to the vmap
    # stack, which runs UNIVERSAL joints
    z = torch.zeros(2, 2, dtype=torch.float64)
    with pytest.warns(UserWarning, match="outside the fused subset"):
        out = rollout_fast(universal, State(q=z, v=z), torch.zeros(1, 2, 2, dtype=torch.float64))
    assert out.q.shape == (2, 2) and torch.isfinite(out.q).all() and torch.isfinite(out.v).all()
    # in the plain version's subset, over a kernel cap: 17 contact pairs
    b = ModelBuilder(dt=1e-3)
    b.add_geom(-1, GeomType.PLANE)
    body = b.add_body(parent=-1, jtype=JointType.FREE)
    for k in range(fs.MAX_PAIRS + 1):
        b.add_geom(body, GeomType.SPHERE, size=(0.1, 0, 0), pos=(0.1 * k, 0, 0))
    many = b.finalize(dtype=torch.float64, device="cpu")
    assert supports_fused(many)
    with pytest.raises(NotImplementedError, match="cap"):
        fs.pack_descriptor(many)
    # model parameters that require grad would be baked as constants: the
    # rollout warns and takes the vmap stack, where the mass gets a gradient
    worm = _worm()
    traced = worm.replace(mass=worm.mass.clone().requires_grad_(True))
    z = torch.zeros(2, 4, dtype=torch.float64)
    with pytest.warns(UserWarning, match="require grad"):
        out = rollout_fast(traced, State(q=z + torch.tensor([0.3, 0, 0, 0.2], dtype=z.dtype), v=z),
                           torch.zeros(1, 2, 4, dtype=torch.float64))
    (g,) = torch.autograd.grad(out.q[:, 0].sum(), traced.mass)
    assert torch.isfinite(g).all()


def test_fallback_reason_follows_the_device():
    """A model inside the fused subset but over a kernel cap (17 bodies)
    takes the fused path's plain version on the CPU and falls back to the
    vmap stack on CUDA, with the cap named; a model within the caps takes
    the fused path on both."""
    b = ModelBuilder(dt=1e-3)
    prev = -1
    for _ in range(fs.MAX_NB + 1):
        prev = b.add_body(parent=prev, jtype=JointType.REVOLUTE, axis=(0, 1, 0), X_pos=(0, 0, -0.1))
    chain = b.finalize(dtype=torch.float64, device="cpu")
    assert supports_fused(chain)
    assert fast._fallback_reason(chain, torch.device("cpu")) is None
    reason = fast._fallback_reason(chain, torch.device("cuda"))
    assert "bodies = 17 exceeds the kernel's cap of 16" in reason
    worm = _worm()
    assert fast._fallback_reason(worm, torch.device("cuda")) is None
    z = torch.zeros(2, chain.nq, dtype=torch.float64)
    out = rollout_fast(chain, State(q=z + 0.1, v=z), torch.zeros(3, 2, chain.nv, dtype=torch.float64))
    assert torch.isfinite(out.q).all() and out.q.shape == (2, chain.nq)


def test_gpu_inputs_that_require_grad_raise():
    """Inputs off the CPU never reach the plain version: on a device that is
    neither the CPU nor CUDA they raise before any launch, with grad
    required or not (meta tensors stand in)."""
    step = fs.build_fused_step(_worm())
    q = torch.zeros(4, 8, device="meta", dtype=torch.float64, requires_grad=True)
    v = torch.zeros(4, 8, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="unsupported device"):
        step(q, v, v)
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported device"):
        step(q, v, v)


def test_fused_step_is_cached_per_model():
    """One FusedStep per model object, rebuilt when a tensor of the model
    changes in place, dropped with the model."""
    m = _worm()
    step = fs.build_fused_step(m)
    assert fs.build_fused_step(m) is step
    assert fs.build_fused_step(m.replace(contact_iters=3)) is not step
    m.mass.mul_(2.0)
    step2 = fs.build_fused_step(m)
    assert step2 is not step and fs.build_fused_step(m) is step2
    assert not np.array_equal(step2._packed[1], step._packed[1])  # the new masses
    n = len(fs._STEPS)
    del m
    gc.collect()
    assert len(fs._STEPS) < n


def test_descriptor_layout_and_caps():
    di, df = fs.pack_descriptor(half_cheetah(dtype=torch.float64, device="cpu"))
    assert di.dtype == np.int32 and df.dtype == np.float64
    # nb nq nv pairs nc nlim nservo nfric D iters passes
    assert di[:11].tolist() == [7, 9, 9, 5, 10, 6, 0, 0, 42, 4, 2]
    assert fs.kernel_unsupported_reason(_worm().replace(contact_iters=4)) is None
    b = ModelBuilder(dt=1e-3)
    prev = -1
    for _ in range(fs.MAX_NB + 1):
        prev = b.add_body(parent=prev, jtype=JointType.REVOLUTE)
    assert "cap" in fs.kernel_unsupported_reason(b.finalize(dtype=torch.float64, device="cpu"))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffdart_tpu_torch as p\n"
        "for mod in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'diffdart_tpu' or n.startswith('diffdart_tpu.')]\n"
        "print(len([n for n in sys.modules if n.startswith('diffdart_tpu_torch')]), bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: val for k, val in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 12, proc.stdout
