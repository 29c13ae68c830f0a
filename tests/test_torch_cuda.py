"""The fused-step kernel and its VJP kernel
(diffdart_tpu_torch/ops/csrc/fused_step.cu) against their plain PyTorch
version on a card. Imports no JAX, so it runs on a machine that has only
PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:randomly -n 0

Skips without a CUDA device. Step tolerances: float64 q atol 1e-8, v atol
1e-7 (the same arithmetic in the same order, so rounding only); float32
allows active-set flips on under 1% of envs (the Woodbury polish amplifies
rounding by about eps/cfm) and requires finite output. VJP tolerances
(diffdart_tpu_torch/ops/vjp_check.py, which says why): float64 against
torch.autograd.grad through the plain version, at rtol 1e-6 plus atol 1e-8
times each array's largest magnitude on >= 99% of envs; float32 against
forward-mode AD of the plain float32 step, the kernel's own mode, at a
median env error of at most 1e-4 and >= 90% of envs within 1e-2.

KERNEL_MODELS covers every joint, contact and row type of the kernel's
subset; tests/test_torch_fused_step.py runs the same models through the
kernel's host build.
"""
import numpy as np
import pytest
import torch

from diffdart_tpu_torch.dynamics.model import (
    GeomType, JointType, ModelBuilder, State, enable_joint_friction, enable_servo)
from diffdart_tpu_torch.models import cheetah_init_q, half_cheetah, jump_worm
from diffdart_tpu_torch.ops import fused_step as fs
from diffdart_tpu_torch.ops import vjp_check as vc
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


# name -> builder(dtype, device) -> (model, q0 as numpy)
KERNEL_MODELS = {
    "worm": _worm,
    "half_cheetah": _half_cheetah,
    "servo_cheetah": _servo_cheetah,
    "free_cube": _free_cube,
    "ball_prismatic": _ball_prismatic,
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
                                         primal=True)
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
    median, share, _ = vc.f32_stats(got, vc.forward_mode_vjp(step.plain, q, v, tau, gq, gv))
    assert vc.f32_ok(median, share), (median, share)


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
