"""The port's torch_bridge.timestep (an alias of its native step) against the
JAX package's bridge, diffdart_tpu/torch_bridge.py (a torch.autograd.Function
around the jitted JAX step), float64 on the CPU: the counterpart of
tests/test_torch_bridge.py.

* One cartpole step: q and v equal the JAX bridge's within 1e-12.
* A 20-step cube_drop chain resting on its contacts (tests/test_torch_bridge.py
  :28-53): the gradient of the final x with respect to the initial x
  velocity equals the JAX bridge's within 1e-8 relative and central
  differences (eps 1e-6) within rtol 1e-4.
* A batch of states gives, row for row, what 1-D calls give.
"""
import numpy as np
import torch

from diffdart_tpu.models import cartpole as jax_cartpole
from diffdart_tpu.models import cube_drop as jax_cube_drop
from diffdart_tpu.torch_bridge import timestep as jax_timestep
from diffdart_tpu_torch.models import cartpole, cube_drop
from diffdart_tpu_torch.torch_bridge import timestep

F64 = torch.float64


def test_forward_matches_jax_bridge():
    m = cartpole(dt=5e-3, dtype=F64, device="cpu")
    q = torch.tensor([0.1, 0.4], dtype=F64)
    v = torch.tensor([-0.2, 0.8], dtype=F64)
    tau = torch.tensor([0.5, 0.0], dtype=F64)
    qn, vn = timestep(m, q, v, tau)
    qj, vj = jax_timestep(jax_cartpole(dt=5e-3), q, v, tau)
    assert qn.shape == (2,) and vn.shape == (2,)
    np.testing.assert_allclose(qn.numpy(), qj.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(vn.numpy(), vj.numpy(), rtol=0, atol=1e-12)


def _chain(step_fn, m, q0, vx, n=20):
    q = q0.clone()
    v = torch.cat([torch.zeros(3, dtype=F64), vx.reshape(1), torch.zeros(2, dtype=F64)])
    tau = torch.zeros(6, dtype=F64)
    for _ in range(n):
        q, v = step_fn(m, q, v, tau)
    return q[4]


def test_multi_step_gradient_matches_jax_bridge_and_fd():
    m = cube_drop(dt=2e-3, half=0.1, friction=0.5, dtype=F64, device="cpu")
    jm = jax_cube_drop(dt=2e-3, half=0.1, friction=0.5)
    q0 = m.neutral_q()
    q0[6] = 0.105

    grads = []
    for fn, model in ((timestep, m), (jax_timestep, jm)):
        vx = torch.tensor(1.0, dtype=F64, requires_grad=True)
        _chain(fn, model, q0, vx).backward()
        grads.append(vx.grad.item())
    g, g_jax = grads
    np.testing.assert_allclose(g, g_jax, rtol=1e-8)

    eps = 1e-6
    with torch.no_grad():
        fd = (_chain(timestep, m, q0, torch.tensor(1.0 + eps, dtype=F64))
              - _chain(timestep, m, q0, torch.tensor(1.0 - eps, dtype=F64))).item() / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-4)


def test_batched_and_1d_inputs_agree():
    m = cube_drop(dt=2e-3, dtype=F64, device="cpu")
    rng = np.random.RandomState(4)
    q = m.neutral_q().repeat(3, 1)
    q[:, 6] = torch.tensor(0.1 + 0.01 * rng.randn(3))
    v = torch.tensor(0.3 * rng.randn(3, m.nv))
    tau = torch.tensor(rng.randn(3, m.nv))
    qb, vb = timestep(m, q, v, tau)
    assert qb.shape == (3, m.nq) and vb.shape == (3, m.nv)
    for i in range(3):
        qi, vi = timestep(m, q[i], v[i], tau[i])
        np.testing.assert_allclose(qi.numpy(), qb[i].numpy(), rtol=0, atol=1e-14)
        np.testing.assert_allclose(vi.numpy(), vb[i].numpy(), rtol=0, atol=1e-14)
