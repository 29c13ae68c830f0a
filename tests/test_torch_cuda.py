"""The fused-step kernel and its VJP kernel
(diffdart_tpu_torch/ops/csrc/fused_step.cu) and the LCP sweep kernel
(ops/csrc/jacobi_sweeps.cu) against their plain PyTorch versions on a card. Imports no JAX, so it runs on a machine that has only
PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:randomly -n 0

Skips without a CUDA device. Step tolerances: float64 q atol 1e-8, v atol
1e-7 (the same arithmetic in the same order, so rounding only); float32
allows active-set flips on under 1% of envs (the Woodbury polish amplifies
rounding by about eps/cfm) and requires finite output. VJP tolerances
(diffdart_tpu_torch/ops/vjp_check.py, which says why): float64 against
torch.autograd.grad through the plain version, at rtol 1e-6 plus atol 1e-8
times each array's largest magnitude on >= 99% of envs; float32 against
reverse-mode autograd of the plain float32 step, the kernel's own mode, at
a median env error of at most 1e-4 and >= 90% of envs within 1e-2. A tape
one node short raises, for one launch and, once per backward pass, for a
rollout. rollout_fast on a model over the fused kernel's
caps (a 17-body chain) warns and runs the vmap stack. The step kernel (one
warp per env) equals the VJP recording's primal bit for bit, and its C
launcher refuses a block over the card's shared memory.

KERNEL_MODELS covers every joint, contact and row type of the kernel's
subset, the convex slots too (the octahedron); tests/test_torch_fused_step.py
runs the same models through the kernel's host build. rollout_fast on the
octahedron launches each kernel once per step with no warning, and a World
loaded from the port's scene files steps on the card as on the CPU.

Sweep kernel: equal bit for bit to its host build (ops/pallas_lcp.py::
host_sweeps, the same per-warp code on the CPU) in both dtypes at B = 1,
13 and 4096 and D = 24, 42 (half-cheetah LCPs) and 80, and at the cap
(167 rows in float64, 238 in float32, where a warp has one buffer);
against ops/lcp.py::_jacobi at D = 9 (a random problem), D =
42 (half-cheetah LCPs) and D = 80 (a random problem past the first
version's cap of 64; above 48 KB of shared memory), odd B, both dtypes,
within
ops/sweep_check.py's limits (float64 1e-12, float32 1e-4, relative to
max(1, |lam|)); the vmap step with contact_solver='lowrank_pallas' (the
kernel) against 'lowrank' (_jacobi) per model: float64 q 1e-8, v 1e-6,
float32 q 1e-4, v 5e-2, on >= 99% of envs (the polish amplifies the
sweeps' rounding difference by about eps/cfm). Bilateral rows (ball,
weld, mimic: lo = -inf, hi = +inf) through the sweep kernel equal its host
build bit for bit. The timestep Jacobians through the kernel (one launch
per call) match those through _jacobi in float64, and a checkpointed BPTT
launches the kernel once per step. The Atlas-class humanoid's LCPs (D = 84
with a contact budget of 12, 147 with every slot; the kernel's direct
path) match _jacobi and the host build, and its rollout through the kernel
launches it once per step.
"""
import numpy as np
import pytest
import torch

from diffdart_tpu_torch.dynamics.model import (
    GeomType, JointType, ModelBuilder, State, enable_joint_friction, enable_servo)
from diffdart_tpu_torch.models import cheetah_init_q, half_cheetah, jump_worm
from diffdart_tpu_torch.ops import fused_step as fs
from diffdart_tpu_torch.ops import pallas_lcp as P
from diffdart_tpu_torch.ops import sweep_check as sc
from diffdart_tpu_torch.ops import vjp_check as vc
from diffdart_tpu_torch.ops.lcp import _jacobi
from diffdart_tpu_torch.sim import step as S
from diffdart_tpu_torch.sim.constrained import prepare_constrained
from diffdart_tpu_torch.sim.fast import rollout_fast

WORM_Q0 = np.array([0.06, 0.0, 0.25, -0.5])


def _worm(dtype, device):
    return jump_worm(dt=2e-3, n_links=2, dtype=dtype, device=device), WORM_Q0


def _half_cheetah(dtype, device):
    m = half_cheetah(dtype=dtype, device=device)
    return m, cheetah_init_q(m).cpu().numpy()


def _servo_cheetah(dtype, device):
    """Half-cheetah with velocity servos and joint Coulomb friction on the
    six leg dofs (constant-box LCP rows), D = 54."""
    m = half_cheetah(dtype=dtype, device=device)
    leg = tuple(range(3, m.nv))
    tgt = np.zeros(m.nv)
    tgt[3:] = [1.5, -1.0, 0.8, -1.2, 1.0, -0.6]
    m = enable_joint_friction(enable_servo(m, leg, force_limit=8.0, target=tgt), leg, friction=0.4)
    return m, cheetah_init_q(m).cpu().numpy() - np.r_[0.25, np.zeros(m.nq - 1)]


def _free_cube(dtype, device):
    """FREE joint with 8-corner box-plane contacts (quaternion FK and
    integration), restitution on."""
    b = ModelBuilder(dt=2e-3)
    b.add_geom(-1, GeomType.PLANE, friction=0.5, restitution=0.5)
    body = b.add_body(parent=-1, jtype=JointType.FREE, inertia=np.eye(3) * 0.01)
    b.add_geom(body, GeomType.BOX, size=(0.1, 0.1, 0.1), friction=0.5, restitution=0.5)
    q0 = np.array([0.9, 0.3, -0.2, 0.25, 0.0, 0.0, 0.12])
    q0[:4] /= np.linalg.norm(q0[:4])
    return b.finalize(dtype=dtype, device=device), q0


def _ball_prismatic(dtype, device):
    """BALL joint with a sphere-plane contact, a PRISMATIC slider with a
    spring and a WELD body."""
    b = ModelBuilder(dt=2e-3)
    b.add_geom(-1, GeomType.PLANE, friction=0.6)
    ball = b.add_body(parent=-1, jtype=JointType.BALL, X_pos=(0, 0, 0.4), com=(0, 0, -0.25),
                      inertia=np.eye(3) * 0.02, damping=0.1)
    g_ball = b.add_geom(ball, GeomType.SPHERE, size=(0.08, 0, 0), pos=(0, 0, -0.35), friction=0.6)
    slider = b.add_body(parent=ball, jtype=JointType.PRISMATIC, axis=(1, 0, 0), mass=0.3,
                        spring_stiff=20.0, q_rest=0.05, q_lo=-0.2, q_hi=0.2)
    weld = b.add_body(parent=slider, jtype=JointType.WELD, X_pos=(0.1, 0, -0.3), mass=0.2)
    b.exclude_pair(g_ball, b.add_geom(weld, GeomType.SPHERE, size=(0.05, 0, 0)))
    return b.finalize(dtype=dtype, device=device), np.array([1.0, 0.1, -0.1, 0.0, 0.02])


def _octahedron(dtype, device):
    """FREE joint with a convex hull of 6 vertices on a plane (4 slots, the
    deepest vertices, D = 12), pivot refinement off (the fused LCP has
    none). The centre 0.05 above the plane puts at least one vertex below
    it in any attitude (an octahedron of radius 0.1 reaches 0.1/sqrt(3)
    down at least)."""
    b = ModelBuilder(dt=2e-3)
    body = b.add_body(parent=-1, jtype=JointType.FREE, mass=1.0, inertia=np.eye(3) * 0.004)
    b.add_geom(body, GeomType.CONVEX, verts=OCTA, friction=0.6)
    b.add_geom(-1, GeomType.PLANE, friction=0.6)
    q0 = np.array([0.9, 0.3, -0.2, 0.25, 0.0, 0.0, 0.05])
    q0[:4] /= np.linalg.norm(q0[:4])
    return b.finalize(dtype=dtype, device=device).replace(lcp_pivot_iters=0), q0


OCTA = 0.1 * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1.0]])

# name -> builder(dtype, device) -> (model, q0 as numpy)
KERNEL_MODELS = {
    "worm": _worm,
    "half_cheetah": _half_cheetah,
    "servo_cheetah": _servo_cheetah,
    "free_cube": _free_cube,
    "ball_prismatic": _ball_prismatic,
    "octahedron": _octahedron,
}


def inputs(q0, nq, nv, B, seed):
    """(B, k) float64 numpy inputs: q0 + 0.02 N, v = 0.2 N, tau = 0.5 N."""
    rng = np.random.RandomState(seed)
    return (np.tile(q0, (B, 1)) + 0.02 * rng.randn(B, nq), 0.2 * rng.randn(B, nv),
            0.5 * rng.randn(B, nv))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _soa_cuda(xs, dtype):
    return [torch.tensor(np.ascontiguousarray(x.T), dtype=dtype, device="cuda") for x in xs]


@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(KERNEL_MODELS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_version(model, dtype):
    _cuda()
    m, q0 = KERNEL_MODELS[model](dtype, "cuda")
    q, v, tau = _soa_cuda(inputs(q0, m.nq, m.nv, 4096, 6), dtype)
    step = fs.build_fused_step(m)
    with torch.no_grad():
        n0 = fs.KERNEL.launches
        qk, vk = step(q, v, tau)
        torch.cuda.synchronize()
        assert fs.KERNEL.launches == n0 + 1
        qp, vp = step.plain(q, v, tau)
    if dtype == torch.float64:
        torch.testing.assert_close(qk, qp, atol=1e-8, rtol=0)
        torch.testing.assert_close(vk, vp, atol=1e-7, rtol=0)
    else:
        ok = ((qk - qp).abs().amax(0) <= 1e-4) & ((vk - vp).abs().amax(0) <= 5e-2)
        assert torch.isfinite(qk).all() and torch.isfinite(vk).all()
        assert ok.float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_launcher_and_front_only(dtype):
    """The step kernel (one warp per env) through its C launcher, odd B: its
    output is the wrapper's; a launch sized for more shared memory than the
    card has (400 LCP rows) is refused before it runs; the launch that stops
    after the front end writes a finite v* and leaves q' as it was."""
    _cuda()
    m, q0 = KERNEL_MODELS["servo_cheetah"](dtype, "cuda")
    B = 999
    q, v, tau = _soa_cuda(inputs(q0, m.nq, m.nv, B, 10), dtype)
    step = fs.build_fused_step(m)
    lib = fs._load("cuda")
    fn = lib.fused_step_f32 if dtype == torch.float32 else lib.fused_step_f64

    def launch(D, front_only=0):
        qo, vo = torch.full_like(q, 7.0), torch.empty_like(v)
        err = fn(*(x.data_ptr() for x in (*step.descriptor(q.device, dtype), q, v, tau, qo, vo)), B,
                 D, m.nv, front_only, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        return err, qo, vo

    with torch.no_grad():
        qk, vk = step(q, v, tau)
    err, qo, vo = launch(step.D)
    assert err == 0 and torch.equal(qo, qk) and torch.equal(vo, vk)
    assert launch(400)[0] != 0
    err, qo, vstar = launch(step.D, front_only=1)
    assert err == 0 and (qo == 7.0).all() and torch.isfinite(vstar).all()
    assert not torch.equal(vstar, vk)


@pytest.mark.cuda
def test_odd_batch_and_launch_count():
    """Any B (no 1024-multiple rule): B = 1000, three steps, three launches."""
    _cuda()
    m = half_cheetah(dtype=torch.float32, device="cuda")
    B = 1000
    state = State(q=cheetah_init_q(m).repeat(B, 1), v=torch.zeros(B, m.nv, device="cuda"))
    taus = torch.zeros(3, B, m.nv, device="cuda")
    with torch.no_grad():
        n0 = fs.KERNEL.launches
        out = rollout_fast(m, state, taus)
    assert fs.KERNEL.launches == n0 + 3
    assert out.q.shape == (B, m.nq) and torch.isfinite(out.q).all()


@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(KERNEL_MODELS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_vjp_kernel_matches_plain_autograd(model, dtype):
    _cuda()
    m, q0 = KERNEL_MODELS[model](dtype, "cuda")
    B = 1024
    q, v, tau = _soa_cuda(inputs(q0, m.nq, m.nv, B, 8), dtype)
    rng = np.random.RandomState(9)
    gq, gv = _soa_cuda((rng.randn(B, m.nq), rng.randn(B, m.nv)), dtype)
    step = fs.build_fused_step(m)
    n0 = fs.VJP_KERNEL.launches
    dq, dv, dtau, qo, vo = fs.VJP_KERNEL(*step.descriptor(q.device, dtype), q, v, tau, gq, gv,
                                         step.tape_capacity(q, v, tau), primal=True)
    torch.cuda.synchronize()
    assert fs.VJP_KERNEL.launches == n0 + 1
    with torch.no_grad():
        qk, vk = step(q, v, tau)
    assert torch.equal(qo, qk) and torch.equal(vo, vk)
    xs = [x.clone().requires_grad_(True) for x in (q, v, tau)]
    want = torch.autograd.grad(step.plain(*xs), xs, (gq, gv))
    got = (dq, dv, dtau)
    assert all(torch.isfinite(x).all() for x in got)
    if dtype == torch.float64:
        assert vc.envs_within(got, want) >= vc.VJP_SHARE
        return
    median, share, _ = vc.f32_stats(got, want)
    assert vc.f32_ok(median, share), (median, share)


@pytest.mark.cuda
def test_vjp_tape_overflow_raises():
    """A tape one node short of the count raises with the counts; the
    counting launch is not a launch of the VJP."""
    _cuda()
    m, q0 = _worm(torch.float32, "cuda")
    q, v, tau = _soa_cuda(inputs(q0, m.nq, m.nv, 64, 3), torch.float32)
    step = fs.build_fused_step(m)
    desc = step.descriptor(q.device, torch.float32)
    n0, c0 = fs.VJP_KERNEL.launches, fs.VJP_KERNEL.count_launches
    nodes = fs.VJP_KERNEL.tape_nodes(*desc, q, v, tau)
    assert (fs.VJP_KERNEL.launches, fs.VJP_KERNEL.count_launches) == (n0, c0 + 1)
    g = torch.ones_like(q), torch.ones_like(v)
    with pytest.raises(RuntimeError, match=f"tape overflow: an env records {nodes} nodes"):
        fs.VJP_KERNEL(*desc, q, v, tau, *g, nodes - 1)
    got = fs.VJP_KERNEL(*desc, q, v, tau, *g, nodes)
    assert all(torch.isfinite(x).all() for x in got)


@pytest.mark.cuda
def test_bptt_tape_overflow_raises_before_the_gradient():
    """A rollout's backward pass reads the tape's overflow status once, in
    its first step's backward: with a tape one node short, all T VJP
    launches run, then the pass raises and no gradient reaches taus."""
    _cuda()
    m, q0 = _worm(torch.float32, "cuda")
    B, T = 64, 3
    q, v, tau = _soa_cuda(inputs(q0, m.nq, m.nv, B, 3), torch.float32)
    step = fs.build_fused_step(m)
    nodes = fs.VJP_KERNEL.tape_nodes(*step.descriptor(q.device, torch.float32), q, v, tau)
    step._tape[torch.float32] = nodes - 1
    state = State(q=q.T.contiguous(), v=v.T.contiguous())
    taus = (0.1 * torch.randn(T, B, m.nv, device="cuda")).requires_grad_(True)
    g0 = fs.VJP_KERNEL.launches
    out = rollout_fast(m, state, taus)
    with pytest.raises(RuntimeError, match=f"tape overflow: an env records {nodes} nodes"):
        (out.q ** 2).sum().backward()
    assert fs.VJP_KERNEL.launches == g0 + T and taus.grad is None
    del step._tape[torch.float32]


@pytest.mark.cuda
def test_rollout_fast_over_the_kernel_caps_falls_back():
    """A 17-body chain is inside the fused subset but over the fused
    kernel's cap of 16 bodies: on the card rollout_fast warns and runs the
    vmap stack, launching no fused-step kernel, and returns finite states."""
    _cuda()
    b = ModelBuilder(dt=1e-3)
    prev = -1
    for _ in range(fs.MAX_NB + 1):
        prev = b.add_body(parent=prev, jtype=JointType.REVOLUTE, axis=(0, 1, 0), X_pos=(0, 0, -0.1))
    chain = b.finalize(dtype=torch.float32, device="cuda")
    B = 64
    state = State(q=torch.full((B, chain.nq), 0.1, device="cuda"), v=torch.zeros(B, chain.nv, device="cuda"))
    n0 = fs.KERNEL.launches
    with pytest.warns(UserWarning, match="bodies = 17 exceeds the kernel's cap of 16"):
        out = rollout_fast(chain, state, 0.1 * torch.randn(5, B, chain.nv, device="cuda"))
    assert fs.KERNEL.launches == n0
    assert out.q.shape == (B, chain.nq) and torch.isfinite(out.q).all() and torch.isfinite(out.v).all()


@pytest.mark.cuda
def test_rollout_tiled_raises_where_the_kernel_cannot_run():
    """On the card rollout_tiled runs the kernels, or the hybrid branch for
    a model in the hybrid LCP mode, as the JAX package does; for a model
    over a cap (the 17-body chain) it raises NotImplementedError with the
    reason and launches nothing. A model with convex slots (an octahedron
    hull) runs on the kernel: one launch per step. The budgeted worm
    (hybrid mode) runs, with no fused launch."""
    _cuda()
    b = ModelBuilder(dt=1e-3)
    prev = -1
    for _ in range(fs.MAX_NB + 1):
        prev = b.add_body(parent=prev, jtype=JointType.REVOLUTE, axis=(0, 1, 0), X_pos=(0, 0, -0.1))
    chain = b.finalize(dtype=torch.float32, device="cuda")
    b = ModelBuilder(dt=2e-3)
    body = b.add_body(parent=-1, jtype=JointType.FREE, mass=1.0, inertia=np.eye(3) * 0.004)
    verts = 0.1 * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1.0]])
    b.add_geom(body, GeomType.CONVEX, verts=verts, friction=0.6)
    b.add_geom(-1, GeomType.PLANE, friction=0.6)
    octa = b.finalize(dtype=torch.float32, device="cuda")
    B = 64
    n0 = fs.KERNEL.launches
    state = State(q=chain.neutral_q().repeat(B, 1), v=torch.zeros(B, chain.nv, device="cuda"))
    with pytest.raises(NotImplementedError, match="bodies = 17 exceeds the kernel's cap of 16"):
        fs.rollout_tiled(chain, state, torch.zeros(2, B, chain.nv, device="cuda"))
    assert fs.KERNEL.launches == n0
    q = octa.neutral_q().repeat(B, 1)
    q[:, -1] += 0.08
    out = fs.rollout_tiled(octa, State(q=q, v=torch.zeros(B, octa.nv, device="cuda")),
                           torch.zeros(2, B, octa.nv, device="cuda"))
    torch.cuda.synchronize()
    assert fs.KERNEL.launches == n0 + 2
    assert torch.isfinite(out.q).all() and torch.isfinite(out.v).all()
    n0 = fs.KERNEL.launches
    worm, wq0 = _worm(torch.float32, "cuda")
    worm = worm.replace(contact_budget=3)
    assert fs.lcp_mode(worm) == "xla"
    q0 = worm.neutral_q() + torch.tensor(wq0, dtype=torch.float32, device="cuda")
    state = State(q=q0.repeat(B, 1), v=torch.zeros(B, worm.nv, device="cuda"))
    out = fs.rollout_tiled(worm, state, 0.1 * torch.randn(2, B, worm.nv, device="cuda"))
    assert fs.KERNEL.launches == n0
    assert torch.isfinite(out.q).all() and torch.isfinite(out.v).all()


@pytest.mark.cuda
def test_bptt_launch_count():
    """rollout_fast with taus that require grad, B = 1000, T = 3, then
    backward: 3 launches of each kernel, a finite non-zero gradient."""
    _cuda()
    m = half_cheetah(dtype=torch.float32, device="cuda")
    B, T = 1000, 3
    state = State(q=cheetah_init_q(m).repeat(B, 1), v=torch.zeros(B, m.nv, device="cuda"))
    taus = (0.1 * torch.randn(T, B, m.nv, device="cuda")).requires_grad_(True)
    n0, g0 = fs.KERNEL.launches, fs.VJP_KERNEL.launches
    out = rollout_fast(m, state, taus)
    ((out.q[:, 1] ** 2).mean() + 1e-4 * (taus**2).mean()).backward()
    torch.cuda.synchronize()
    assert fs.KERNEL.launches == n0 + T and fs.VJP_KERNEL.launches == g0 + T
    assert torch.isfinite(taus.grad).all() and taus.grad.abs().sum() > 0


@pytest.mark.cuda
def test_cuda_inputs_that_require_grad_get_gradients():
    """A CUDA input that requires grad goes through the two kernels: the
    gradient flows to q, v and tau, and matches plain autograd in float64."""
    _cuda()
    m, q0 = _half_cheetah(torch.float64, "cuda")
    q, v, tau = (x.requires_grad_(True) for x in _soa_cuda(inputs(q0, m.nq, m.nv, 64, 7), torch.float64))
    step = fs.build_fused_step(m)
    g0 = fs.VJP_KERNEL.launches
    qn, vn = step(q, v, tau)
    got = torch.autograd.grad((qn**2).sum() + (vn**2).sum(), (q, v, tau))
    assert fs.VJP_KERNEL.launches == g0 + 1
    xs = [x.detach().clone().requires_grad_(True) for x in (q, v, tau)]
    qp, vp = step.plain(*xs)
    want = torch.autograd.grad((qp**2).sum() + (vp**2).sum(), xs)
    assert all(torch.isfinite(x).all() and x.abs().sum() > 0 for x in got)
    assert vc.envs_within(got, want) >= vc.VJP_SHARE


def _sweep_problem(D, B, dtype):
    """(A, b, lo, hi, mu, fidx, iters) on the card: D = 9, a random
    problem (3 contacts, rank 5, tests/test_pallas_lcp.py's generator);
    D = 42, the half-cheetah's LCPs at perturbed states."""
    if D == 9:
        rng = np.random.default_rng(B)
        J = rng.normal(size=(B, 9, 5))
        A = np.einsum("bik,bjk->bij", J, J) + 1e-3 * np.eye(9)
        lo = np.zeros((B, 9))
        hi = np.concatenate([np.full((B, 3), np.inf), np.zeros((B, 6))], axis=1)
        mu = np.concatenate([np.zeros((B, 3)), np.full((B, 6), 0.5)], axis=1)
        xs = [torch.tensor(x, dtype=dtype, device="cuda") for x in (A, rng.normal(size=(B, 9)), lo, hi, mu)]
        return (*xs, torch.tensor([-1, -1, -1, 0, 1, 2, 0, 1, 2], device="cuda"), 6)
    m, q0 = _half_cheetah(dtype, "cuda")
    q, v, tau = (torch.tensor(x, dtype=dtype, device="cuda") for x in inputs(q0, m.nq, m.nv, B, 10))
    with torch.no_grad():
        lcp = prepare_constrained(m, State(q=q, v=v), tau)[0]
    return (lcp.A, lcp.b, lcp.lo, lcp.hi, lcp.mu, lcp.fidx, m.contact_iters)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [13, 1001])
@pytest.mark.parametrize("D", [9, 42])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sweep_kernel_matches_plain_version(dtype, D, B):
    _cuda()
    A, b, lo, hi, mu, fidx, iters = _sweep_problem(D, B, dtype)
    n0, n1 = P.KERNEL.launches, P.KERNEL_SINGLE.launches
    got = P.jacobi_sweeps_pallas(A, b, lo, hi, mu, fidx, iters)
    got1 = P.jacobi_sweeps_pallas_single(A, b, lo, hi, mu, fidx, iters)
    torch.cuda.synchronize()
    assert (P.KERNEL.launches, P.KERNEL_SINGLE.launches) == (n0 + 1, n1 + 1)
    want = _jacobi(A, b, lo, hi, mu, fidx, iters)
    assert torch.equal(got, got1)
    assert sc.sweep_ok(got, want), sc.sweep_error(got, want)
    assert want.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sweep_kernel_past_64_rows(dtype):
    """D = 80 (51 KB of shared memory in float64, past the 48 KB default):
    the kernel against _jacobi within sweep_check's limits."""
    _cuda()
    rng = np.random.default_rng(80)
    B, D, nc, nv = 17, 80, 26, 20
    J = rng.normal(size=(B, D, nv))
    A = np.einsum("bik,bjk->bij", J, J) + 1e-3 * np.eye(D)
    hi = np.zeros((B, D))
    hi[:, :nc] = hi[:, 3 * nc:] = np.inf
    mu = np.zeros((B, D))
    mu[:, nc:3 * nc] = 0.5
    fidx = np.full(D, -1)
    fidx[nc:3 * nc] = np.tile(np.arange(nc), 2)
    args = [torch.tensor(x, dtype=dtype, device="cuda") for x in (A, rng.normal(size=(B, D)), np.zeros((B, D)), hi, mu)]
    f = torch.tensor(fidx, device="cuda")
    n0 = P.KERNEL_SINGLE.launches
    got = P.jacobi_sweeps_pallas_single(*args, f, 6)
    torch.cuda.synchronize()
    assert P.KERNEL_SINGLE.launches == n0 + 1
    want = _jacobi(*args, f, 6)
    assert sc.sweep_ok(got, want), sc.sweep_error(got, want)
    assert want.abs().max() > 0


def _random_lcp(D, B, seed, nv=12):
    """A random boxed LCP of D rows, float64 numpy: D // 3 contacts (a
    normal row, two friction rows), then limit rows with lo = 0, hi = inf."""
    rng = np.random.default_rng(seed)
    nc = D // 3
    J = rng.normal(size=(B, D, nv))
    A = np.einsum("bik,bjk->bij", J, J) + 1e-3 * np.eye(D)
    hi = np.zeros((B, D))
    hi[:, :nc] = hi[:, 3 * nc:] = np.inf
    mu = np.zeros((B, D))
    mu[:, nc:3 * nc] = 0.5
    fidx = np.full(D, -1)
    fidx[nc:3 * nc] = np.tile(np.arange(nc), 2)
    return A, rng.normal(size=(B, D)), np.zeros((B, D)), hi, mu, fidx


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 13, 4096])
@pytest.mark.parametrize("D", [24, 42, 80])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sweep_kernel_equals_host_build(dtype, D, B):
    """The kernel's lam equals its host build's bit for bit: the same
    serial order per row, whatever the warps, buffers and grid."""
    _cuda()
    if D == 42:
        A, b, lo, hi, mu, fidx, iters = _sweep_problem(42, B, dtype)
    else:
        *xs, f = _random_lcp(D, B, seed=D + B)
        A, b, lo, hi, mu = (torch.tensor(x, dtype=dtype, device="cuda") for x in xs)
        fidx, iters = torch.tensor(f, device="cuda"), 4
    n0 = P.KERNEL.launches
    got = P.jacobi_sweeps_pallas(A, b, lo, hi, mu, fidx, iters)
    torch.cuda.synchronize()
    assert P.KERNEL.launches == n0 + 1
    want = P.host_sweeps(A, b, lo, hi, mu, fidx, iters, dtype=dtype)
    assert torch.isfinite(want).all() and want.abs().max() > 0
    assert torch.equal(got.cpu(), want), (got.cpu() - want).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sweep_kernel_at_the_cap_equals_host_build(dtype):
    """At the cap (167 rows in float64, 238 in float32 on the H100) the
    kernel takes the direct path, and reads b, lo, hi, mu from device
    memory. At D = 42 float32 takes the register path."""
    _cuda()
    D = P.max_rows(dtype)
    assert D == {torch.float64: 167, torch.float32: 238}[dtype]
    cfg = P.launch_config(dtype, D)
    assert not cfg["register_path"] and cfg["warps_per_sm"] >= 1
    assert P.launch_config(dtype, 42)["register_path"] == (dtype == torch.float32)
    *xs, f = _random_lcp(D, 5, seed=D)
    args = [torch.tensor(x, dtype=dtype, device="cuda") for x in xs]
    fidx = torch.tensor(f, device="cuda")
    got = P.jacobi_sweeps_pallas_single(*args, fidx, 3)
    torch.cuda.synchronize()
    want = P.host_sweeps(*args, fidx, 3, dtype=dtype)
    assert torch.isfinite(want).all() and want.abs().max() > 0
    assert torch.equal(got.cpu(), want), (got.cpu() - want).abs().max()


@pytest.mark.cuda
def test_sweep_wrapper_raises():
    _cuda()
    A, b, lo, hi, mu, fidx, iters = _sweep_problem(9, 8, torch.float64)
    with pytest.raises(ValueError, match="is on cpu"):
        P.jacobi_sweeps_pallas(A, b.cpu(), lo, hi, mu, fidx, iters)
    with pytest.raises(TypeError, match="float32 or float64"):
        P.jacobi_sweeps_pallas(*(x.half() for x in (A, b, lo, hi, mu)), fidx, iters)
    D = P.max_rows(torch.float64) + 1
    assert D - 1 >= 160  # 227 KB of shared memory on the H100 holds 167 rows in float64
    big = torch.eye(D, dtype=torch.float64, device="cuda").expand(2, D, D)
    vec = torch.zeros(2, D, dtype=torch.float64, device="cuda")
    with pytest.raises(NotImplementedError, match=f"D = {D} exceeds the kernel's cap of {D - 1} rows"):
        P.jacobi_sweeps_pallas_single(big, vec, vec, vec, vec, torch.full((D,), -1, device="cuda"),
                                      iters)
    with pytest.raises(RuntimeError, match="forward only"):
        P.jacobi_sweeps_pallas(A, b.clone().requires_grad_(True), lo, hi, mu, fidx, iters)


@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(KERNEL_MODELS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_vmap_step_through_the_kernel_matches_plain_sweeps(model, dtype):
    _cuda()
    m, q0 = KERNEL_MODELS[model](dtype, "cuda")
    q, v, tau = (torch.tensor(x, dtype=dtype, device="cuda") for x in inputs(q0, m.nq, m.nv, 1024, 11))
    with torch.no_grad():
        n0 = P.KERNEL_SINGLE.launches
        k = S.step(m.replace(contact_solver="lowrank_pallas"), State(q=q, v=v), tau)
        torch.cuda.synchronize()
        assert P.KERNEL_SINGLE.launches == n0 + 1
        p = S.step(m.replace(contact_solver="lowrank"), State(q=q, v=v), tau)
    tq, tv = (1e-8, 1e-6) if dtype == torch.float64 else (1e-4, 5e-2)
    ok = ((k.q - p.q).abs().amax(1) <= tq) & ((k.v - p.v).abs().amax(1) <= tv)
    assert torch.isfinite(k.q).all() and torch.isfinite(k.v).all()
    assert ok.double().mean() >= 0.99, ok.double().mean()


@pytest.mark.cuda
def test_jacobians_through_the_kernel_match_plain_sweeps():
    """neural/jacobians.py::timestep_jacobians with 'lowrank_pallas' (the
    sweep kernel, one launch per call) against 'lowrank' (_jacobi), the
    half-cheetah at B = 64 in float64, on the envs whose LCP converged:
    within ops/vjp_check.py's limits."""
    _cuda()
    from diffdart_tpu_torch.neural import timestep_jacobians
    from diffdart_tpu_torch.sim.constrained import solver_diagnostics

    m, q0 = _half_cheetah(torch.float64, "cuda")
    q, v, tau = (torch.tensor(x, dtype=torch.float64, device="cuda") for x in inputs(q0, m.nq, m.nv, 64, 12))
    q[:, 0] -= 0.1  # feet on the floor
    mk = m.replace(contact_solver="lowrank_pallas")
    with torch.no_grad():
        conv = solver_diagnostics(mk, State(q=q, v=v), tau) < 1e-8
    n0 = P.KERNEL_SINGLE.launches
    jk = timestep_jacobians(mk, State(q=q, v=v), tau)
    torch.cuda.synchronize()
    assert P.KERNEL_SINGLE.launches == n0 + 1
    jp = timestep_jacobians(m.replace(contact_solver="lowrank"), State(q=q, v=v), tau)
    assert conv.sum() >= 8
    for a, b in zip(jk, jp):
        a, b = a[conv], b[conv]
        assert torch.isfinite(a).all()
        assert ((a - b).abs() <= vc.VJP_RTOL * b.abs() + vc.VJP_ATOL * b.abs().max()).all()


@pytest.mark.cuda
def test_checkpointed_bptt_launches_the_sweeps_once_per_step():
    """rollout_checkpointed keeps each step's LCP impulse: T sweep launches
    in forward plus backward (half-cheetah, B = 512, T = 3, float32, the
    mass requiring grad), a finite non-zero gradient."""
    _cuda()
    m = half_cheetah(dtype=torch.float32, device="cuda").replace(contact_solver="lowrank_pallas")
    B, T = 512, 3
    mass = m.mass.clone().requires_grad_(True)
    state = State(q=cheetah_init_q(m).repeat(B, 1), v=torch.zeros(B, m.nv, device="cuda"))
    taus = (0.1 * torch.randn(T, B, m.nv, device="cuda")).requires_grad_(True)
    n0 = P.KERNEL_SINGLE.launches
    out = S.rollout_checkpointed(m.replace(mass=mass), state, taus)
    (out.q[:, 1] ** 2).mean().backward()
    torch.cuda.synchronize()
    assert P.KERNEL_SINGLE.launches == n0 + T
    for g in (taus.grad, mass.grad):
        assert torch.isfinite(g).all() and g.abs().sum() > 0


def _bilateral_models(dtype):
    """A free body ball-pinned to the world and a welded pair of free bodies
    (tests/test_bilateral.py), and a double pendulum with a mimic row."""
    from diffdart_tpu_torch.dynamics.model import add_ball_constraint, add_mimic_constraint, add_weld_constraint
    from diffdart_tpu_torch.models import double_pendulum

    def free(n, **kw):
        b = ModelBuilder(dt=1e-3)
        for _ in range(n):
            b.add_body(parent=-1, jtype=JointType.FREE, inertia=np.eye(3) * 0.01, **kw)
        return b.finalize(dtype=dtype, device="cuda")

    pair = free(2)
    q = pair.neutral_q()
    q[11] = 0.4
    return {"ball": add_ball_constraint(free(1, com=(0.3, 0, 0)), -1, 0, world_point=(0, 0, 0)),
            "weld": add_weld_constraint(pair, 0, 1, q=q),
            "mimic": add_mimic_constraint(double_pendulum(dtype=dtype, device="cuda"), 1, 0, 0.5, 0.1)}


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["ball", "weld", "mimic"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bilateral_rows_through_the_kernel_equal_host_build(model, dtype):
    """LCPs with bilateral rows (lo = -inf, hi = +inf), B = 1001: the sweep
    kernel equals its host build bit for bit and _jacobi within
    ops/sweep_check.py's limits."""
    _cuda()
    m = _bilateral_models(dtype)[model]
    rng = np.random.RandomState(13)
    q = torch.tensor(m.neutral_q().cpu().numpy() + 1e-3 * rng.randn(1001, m.nq), dtype=dtype, device="cuda")
    v = torch.tensor(0.5 * rng.randn(1001, m.nv), dtype=dtype, device="cuda")
    with torch.no_grad():
        lcp = prepare_constrained(m, State(q=q, v=v))[0]
    assert torch.isinf(lcp.lo).all() and torch.isinf(lcp.hi).all()
    args = (lcp.A, lcp.b, lcp.lo, lcp.hi, lcp.mu)
    got = P.jacobi_sweeps_pallas_single(*args, lcp.fidx, m.contact_iters)
    host = P.host_sweeps(*args, lcp.fidx, m.contact_iters, dtype=dtype)
    want = _jacobi(*args, lcp.fidx, m.contact_iters)
    assert torch.equal(got.cpu(), host)
    assert sc.sweep_ok(got, want)


def _humanoid_lcp(dtype, budget, B, seed=21):
    """The humanoid's LCPs on the card at a perturbed standing state (the
    root 5 mm low, the joints +-0.05 rad, v ~ 0.1 N(0,1)): D = 84 with a
    contact budget of 12, D = 147 with all 33 slots."""
    from diffdart_tpu_torch.models import humanoid, humanoid_init_q

    m = humanoid(dtype=dtype, device="cuda").replace(contact_budget=budget)
    rng = np.random.RandomState(seed)
    q = np.tile(humanoid_init_q(m).cpu().numpy(), (B, 1))
    q[:, 6] -= 0.005
    q[:, 7:] += 0.05 * (2 * rng.rand(B, m.nq - 7) - 1)
    v = 0.1 * rng.randn(B, m.nv)
    with torch.no_grad():
        lcp = prepare_constrained(m, State(q=torch.tensor(q, dtype=dtype, device="cuda"),
                                           v=torch.tensor(v, dtype=dtype, device="cuda")))[0]
    return m, lcp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,budget", [(torch.float32, 12), (torch.float32, 0), (torch.float64, 0)])
def test_humanoid_sweeps_match_plain_version_and_host_build(dtype, budget):
    """The Atlas-class humanoid's LCPs (D = 84 and 147, B = 257), on the
    kernel's direct path: against _jacobi within ops/sweep_check.py's
    limits, and against the host build bit for bit."""
    _cuda()
    m, lcp = _humanoid_lcp(dtype, budget, B=257)
    D = lcp.b.shape[-1]
    assert D == (84 if budget else 147)
    assert not P.launch_config(dtype, D)["register_path"]
    args = (lcp.A, lcp.b, lcp.lo, lcp.hi, lcp.mu)
    n0 = P.KERNEL_SINGLE.launches
    got = P.jacobi_sweeps_pallas_single(*args, lcp.fidx, m.contact_iters)
    torch.cuda.synchronize()
    assert P.KERNEL_SINGLE.launches == n0 + 1
    want = _jacobi(*args, lcp.fidx, m.contact_iters)
    host = P.host_sweeps(*args, lcp.fidx, m.contact_iters, dtype=dtype)
    assert sc.sweep_ok(got, want), sc.sweep_error(got, want)
    assert torch.equal(got.cpu(), host)
    assert want.abs().max() > 0


@pytest.mark.cuda
def test_humanoid_rollout_through_the_kernel():
    """The humanoid's vmap rollout with 'lowrank_pallas', float32, B = 256,
    T = 10, zero tau, every slot: T sweep launches, a finite final state
    with the root above 0.2; rollout_fast warns and takes the vmap stack."""
    _cuda()
    from diffdart_tpu_torch.models import humanoid, humanoid_init_q

    m = humanoid(dtype=torch.float32, device="cuda").replace(contact_solver="lowrank_pallas")
    B, T = 256, 10
    state = State(q=humanoid_init_q(m).repeat(B, 1), v=torch.zeros(B, m.nv, device="cuda"))
    taus = torch.zeros(T, B, m.nv, device="cuda")
    n0 = P.KERNEL_SINGLE.launches
    with torch.no_grad():
        fin = S.rollout_final(m, state, taus)
    torch.cuda.synchronize()
    assert P.KERNEL_SINGLE.launches == n0 + T
    assert torch.isfinite(fin.q).all() and torch.isfinite(fin.v).all()
    assert (fin.q[:, 6] > 0.2).all()
    with pytest.warns(UserWarning, match="the hybrid LCP runs outside the kernel"), torch.no_grad():
        rollout_fast(m, state, taus[:2])


@pytest.mark.cuda
def test_octahedron_rollout_fast_launches_both_kernels():
    """rollout_fast on the octahedron (convex slots), float32, B = 1024,
    T = 5, taus that require grad: T launches of the step kernel and, in
    the backward pass, T of the VJP kernel, no warning, a finite gradient."""
    import warnings

    _cuda()
    m, q0 = _octahedron(torch.float32, "cuda")
    B, T = 1024, 5
    q, v, _ = (torch.tensor(x, dtype=torch.float32, device="cuda") for x in inputs(q0, m.nq, m.nv, B, 21))
    taus = (0.1 * torch.randn(T, B, m.nv, device="cuda")).requires_grad_(True)
    n0, g0 = fs.KERNEL.launches, fs.VJP_KERNEL.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        out = rollout_fast(m, State(q=q, v=v), taus)
        (out.q[:, 6] ** 2).mean().backward()
    torch.cuda.synchronize()
    assert fs.KERNEL.launches == n0 + T and fs.VJP_KERNEL.launches == g0 + T
    assert torch.isfinite(out.q).all() and torch.isfinite(taus.grad).all()
    assert taus.grad.abs().max() > 0


@pytest.mark.cuda
def test_world_on_the_card_matches_the_cpu():
    """A World loaded from the port's scene files (SKEL, SDF, VSK, URDF)
    on the card, float64, 20 steps from seeded velocities, equals the same
    World on the CPU within 1e-10."""
    import os

    from diffdart_tpu_torch.sim.world import World

    _cuda()
    scenes = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "diffdart_tpu_torch", "assets", "scenes")
    for fname in ("pendulum.skel", "pendulum.sdf", "leg.vsk", "twolink.urdf"):
        ends = []
        for dev in ("cuda", "cpu"):
            w = World(dtype=torch.float64, device=dev)
            w.loadSkeleton(os.path.join(scenes, fname))
            w.setVelocities(0.3 * np.random.RandomState(3).randn(w.model.nv))
            for _ in range(20):
                w.step()
            ends.append((w.getPositions().cpu(), w.getVelocities().cpu()))
        assert (ends[0][0] - ends[1][0]).abs().max() <= 1e-10, fname
        assert (ends[0][1] - ends[1][1]).abs().max() <= 1e-10, fname


def _dp_cheetah(B, T, seed=31):
    """The data-parallel BPTT of chip_smoke phase 31 at a small size: the
    half-cheetah, float32, a shared control tape (T, nv) as the replicated
    params, per-env noise 0.1 N(0, 1) in the batch, per-env loss
    q_T[:, 1]^2 + 1e-4 mean(tau^2)."""
    m = half_cheetah(dt=2e-3, dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"state": State(q=cheetah_init_q(m).repeat(B, 1), v=torch.zeros(B, m.nv, device="cuda")),
             "noise": 0.1 * torch.randn(B, T, m.nv, device="cuda", generator=g)}

    def per_env(tape, b):
        taus = (tape[None] + b["noise"]).transpose(0, 1)
        final = rollout_fast(m, b["state"], taus)
        return final.q[:, 1] ** 2 + 1e-4 * (taus**2).mean((0, 2))

    return m, batch, per_env, torch.zeros(T, m.nv, device="cuda")


@pytest.mark.cuda
def test_data_parallel_step_on_the_card_equals_plain_bptt():
    """make_mesh(1) on the card: data_parallel_grad launches each fused
    kernel T times and gives the plain mean loss and its gradient bit for
    bit (B a power of two, so the division by B is exact)."""
    from diffdart_tpu_torch.parallel import data_parallel_grad, make_mesh, shard_batch

    _cuda()
    B, T = 512, 10
    _, batch, per_env, tape = _dp_cheetah(B, T)
    mesh = make_mesh(1)
    assert mesh.devices == (torch.device("cuda", 0),)
    n0, g0 = fs.KERNEL.launches, fs.VJP_KERNEL.launches
    loss, grad = data_parallel_grad(per_env, mesh)(tape, shard_batch(mesh, batch))
    torch.cuda.synchronize()
    assert fs.KERNEL.launches == n0 + T and fs.VJP_KERNEL.launches == g0 + T
    x = tape.clone().requires_grad_(True)
    ref = per_env(x, batch).mean()
    ref.backward()
    assert torch.equal(loss, ref.detach()) and torch.equal(grad, x.grad)
    assert grad.abs().max() > 0


@pytest.mark.cuda
def test_device_trace_records_every_step_kernel(tmp_path):
    """device_trace around rollout_fast on the card, in this test session's
    process: T step-kernel events by name, each launch with its kernel
    event (device_trace raises otherwise), and the scope."""
    import json

    from diffdart_tpu_torch.utils.profile import device_trace, named_scope

    _cuda()
    B, T = 256, 10
    m = half_cheetah(dt=2e-3, dtype=torch.float32, device="cuda")
    state = State(q=cheetah_init_q(m).repeat(B, 1), v=torch.zeros(B, m.nv, device="cuda"))
    taus = 0.1 * torch.randn(T, B, m.nv, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    with torch.no_grad():
        rollout_fast(m, state, taus)
        n0 = fs.KERNEL.launches
        with device_trace(str(tmp_path)) as prof:
            with named_scope("rollout"):
                rollout_fast(m, state, taus)
    assert fs.KERNEL.launches == n0 + T and prof.kernel_launches >= T
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("cat") == "kernel" and "fused_step_kernel" in e["name"] for e in events) == T
    assert any(e.get("name") == "rollout" and e.get("cat") == "user_annotation" for e in events)


@pytest.mark.cuda
def test_checkpoint_resume_on_the_card(tmp_path):
    """A data-parallel Adam loop on the card: 3 steps, save, restore on the
    card, 2 steps equal 5 straight steps bit for bit."""
    from diffdart_tpu_torch.parallel import data_parallel_grad, make_mesh, shard_batch
    from diffdart_tpu_torch.utils import restore_checkpoint, save_checkpoint

    _cuda()
    _, batch, per_env, tape0 = _dp_cheetah(256, 8)
    mesh = make_mesh(1)
    step = data_parallel_grad(per_env, mesh)
    sb = shard_batch(mesh, batch)

    def fresh():
        p = torch.nn.Parameter(tape0.clone())
        return p, torch.optim.Adam([p], lr=0.05)

    def run(p, opt, n):
        for _ in range(n):
            _, g = step(p.detach(), sb)
            p.grad = g
            opt.step()

    p, opt = fresh()
    run(p, opt, 5)
    pa, opta = fresh()
    run(pa, opta, 3)
    fname = save_checkpoint(str(tmp_path / "ck"), {"tape": pa, "opt": opta.state_dict()}, step=3)
    pb, optb = fresh()
    ck = restore_checkpoint(fname, like={"tape": pb, "opt": optb.state_dict()})
    assert ck["tape"].device == pb.device
    with torch.no_grad():
        pb.copy_(ck["tape"])
    optb.load_state_dict(ck["opt"])
    run(pb, optb, 2)
    assert torch.equal(pb, p) and p.abs().max() > 0


@pytest.mark.cuda
def test_frame_from_a_card_state_matches_the_cpu():
    """state_frame and trajectory_frames of the half-cheetah from positions
    on the card equal those from the same positions on the CPU within one
    unit in the fifth place (both round to 5 places; a value on a rounding
    boundary may round either way)."""
    from diffdart_tpu_torch.viewer import state_frame, trajectory_frames

    _cuda()
    frames = []
    for dev in ("cuda", "cpu"):
        m = half_cheetah(dt=2e-3, dtype=torch.float64, device=dev)
        qs = cheetah_init_q(m).repeat(6, 1) + 0.3 * torch.tensor(
            np.random.RandomState(2).randn(6, m.nq), device=dev)
        frames.append([state_frame(m, qs[0], t=0.1)] + trajectory_frames(m, qs, stride=2))
    for a, b in zip(*frames):
        assert a["t"] == b["t"] and len(a["poses"]) == len(b["poses"])
        for pa, pb in zip(a["poses"], b["poses"]):
            d = np.abs(np.subtract(pa["pos"] + pa["quat"], pb["pos"] + pb["quat"]))
            assert np.round(d * 1e5).max() <= 1


@pytest.mark.cuda
def test_bridge_timestep_with_the_sweep_kernel_matches_the_cpu():
    """torch_bridge.timestep on cube_drop with contact_solver='lowrank_pallas',
    float64, 20 steps, landing on its contacts: one sweep-kernel launch per
    step on the card, q and v within 1e-9 of the CPU's, and the chain's
    gradient within 1e-8 relative."""
    from diffdart_tpu_torch.models import cube_drop
    from diffdart_tpu_torch.torch_bridge import timestep

    _cuda()
    out = []
    for dev in ("cuda", "cpu"):
        m = cube_drop(dt=2e-3, half=0.1, friction=0.5, dtype=torch.float64,
                      device=dev).replace(contact_solver="lowrank_pallas")
        q = m.neutral_q()
        q[6] = 0.105
        vx = torch.tensor(1.0, dtype=torch.float64, device=dev, requires_grad=True)
        v = torch.cat([torch.zeros(3, dtype=torch.float64, device=dev), vx.reshape(1),
                       torch.zeros(2, dtype=torch.float64, device=dev)])
        tau = torch.zeros(6, dtype=torch.float64, device=dev)
        n0 = P.KERNEL_SINGLE.launches
        for _ in range(20):
            q, v = timestep(m, q, v, tau)
        launches = P.KERNEL_SINGLE.launches - n0
        q[4].backward()
        out.append((q.detach().cpu(), v.detach().cpu(), vx.grad.item(), launches))
    assert out[0][3] == 20 and out[1][3] == 0
    assert (out[0][0] - out[1][0]).abs().max() <= 1e-9 and (out[0][1] - out[1][1]).abs().max() <= 1e-9
    assert abs(out[0][2] - out[1][2]) <= 1e-8 * abs(out[1][2])
