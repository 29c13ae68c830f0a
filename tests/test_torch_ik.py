"""The port's IK mappings (diffdart_tpu_torch/neural/mappings.py) against the
JAX package's (diffdart_tpu/neural/mappings.py), float64 on the CPU.

The cases of tests/test_ik.py, each solved by both packages from the same
start: the port batch-first with B = 2, the JAX package on one env (one
jit per case). For the single-body IK the second env starts from a seeded
other point and is held to its own JAX solve; hierarchical IK, whose lower
levels drift chaotically in the nullspace (a start 0.2 rad away ends far
apart in both packages), takes the case's start twice, and the two envs
must agree bit for bit. Solutions agree within 1e-8 (both run the same
damped Gauss-Newton iterations; the linear solves round differently), task
errors within 1e-10, the task Jacobian to 1e-12; the cases' own thresholds
hold too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffdart_tpu.dynamics.kinematics import fk as jax_fk
from diffdart_tpu.math.lie import tf_apply as jax_tf_apply
from diffdart_tpu.models import chain as jax_chain
from diffdart_tpu.neural import HierarchicalIK as JHierarchicalIK
from diffdart_tpu.neural import IKMapping as JIKMapping
from diffdart_tpu.neural import solve_ik as jax_solve_ik
from diffdart_tpu_torch.dynamics.dynamics import integrate_positions
from diffdart_tpu_torch.models import chain
from diffdart_tpu_torch.neural import HierarchicalIK, IdentityMapping, IKMapping, solve_ik

F64 = torch.float64


def pair(n):
    return chain(n=n, length=0.3, dtype=F64, device="cpu"), jax_chain(n=n, length=0.3)


def starts(q0, seed):
    """(2, nq): the case's start and a seeded one near it."""
    q0 = np.asarray(q0, np.float64)
    return np.stack([q0, q0 + 0.2 * np.random.RandomState(seed).randn(q0.size)])


def close(x, y, atol):
    np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol, rtol=0)


def test_solve_reaches_target():
    m, jm = pair(4)
    q_true = jnp.array([0.4, -0.3, 0.6, 0.2])
    target = jax_fk(jm, q_true)[1][3]
    q0 = starts(np.zeros(4), 1)
    q, err = solve_ik(m, 3, torch.tensor(np.asarray(target)), torch.tensor(q0), iters=80)
    assert q.shape == (2, 4) and err.shape == (2,)
    jsolve = jax.jit(lambda t, q_: jax_solve_ik(jm, 3, t, q_, iters=80))
    for e in range(2):
        jq, jerr = jsolve(target, jnp.asarray(q0[e]))
        close(q[e], jq, 1e-8)
        close(err[e], jerr, 1e-10)
    assert float(err.max()) < 1e-5


def test_ik_mapping_roundtrip():
    m, jm = pair(3)
    mp, jmp = IKMapping(m, [2], iters=60), JIKMapping(jm, [2], iters=60)
    q = torch.tensor([[0.3, -0.5, 0.8]], dtype=F64)
    z = mp.map_pos(q)
    close(z[0], jmp.map_pos(jnp.asarray(q[0].numpy())), 1e-15)
    q0 = starts(np.zeros(3), 2)
    q2 = mp.unmap_pos(z.expand(2, -1), torch.tensor(q0))
    junmap = jax.jit(jmp.unmap_pos)
    for e in range(2):
        close(q2[e], junmap(jnp.asarray(z[0].numpy()), jnp.asarray(q0[e])), 1e-8)
    close(mp.map_pos(q2), z.expand(2, -1), 1e-6)


def test_task_velocity_consistent():
    """map_vel equals the JAX package's and the central difference of
    map_pos along the tangent; the Jacobian equals jax.jacfwd's."""
    m, jm = pair(3)
    mp, jmp = IKMapping(m, [2]), JIKMapping(jm, [2])
    q = torch.tensor(starts([0.2, 0.4, -0.1], 3))
    v = torch.tensor([[1.0, -0.5, 0.3], [0.2, 0.1, -0.7]], dtype=F64)
    zdot = mp.map_vel(q, v)
    J = mp.jacobian(q)
    for e in range(2):
        close(J[e], jmp.jacobian(jnp.asarray(q[e].numpy())), 1e-12)
        close(zdot[e], jmp.map_vel(jnp.asarray(q[e].numpy()), jnp.asarray(v[e].numpy())), 1e-12)
    eps = 1e-6
    fd = (mp.map_pos(integrate_positions(m, q, v, eps)) - mp.map_pos(integrate_positions(m, q, -v, eps))) / (2 * eps)
    close(zdot, fd, 1e-6)
    assert torch.equal(IdentityMapping(m).map_pos(q), q)


def _hik_case(hik, jhik, targets_np, nq):
    """Both packages from q = 0: the port on two copies of it."""
    q, errs = hik.solve([torch.tensor(t) for t in targets_np], torch.zeros(2, nq, dtype=F64))
    assert q.shape == (2, nq) and errs.shape == (2, len(targets_np))
    assert torch.equal(q[0], q[1]) and torch.equal(errs[0], errs[1])
    jq, jerrs = jax.jit(jhik.solve)([jnp.asarray(t) for t in targets_np], jnp.zeros(nq))
    close(q[0], jq, 1e-8)
    close(errs[0], jerrs, 1e-10)
    return q, errs


def test_two_level_priorities():
    m, jm = pair(6)
    p = jax_fk(jm, jnp.array([0.4, -0.3, 0.5, 0.2, -0.4, 0.3]))[1]
    targets = [np.asarray(p[5])[None], np.asarray(p[2])[None]]
    levels = [[(5, (0, 0, 0))], [(2, (0, 0, 0))]]
    _, errs = _hik_case(HierarchicalIK(m, levels, iters=80), JHierarchicalIK(jm, levels, iters=80),
                        targets, 6)
    assert float(errs[0, 0]) < 1e-4 and float(errs[0, 1]) < 5e-2


def test_primary_wins_on_conflict():
    m, jm = pair(4)
    p = jax_fk(jm, jnp.array([0.3, 0.3, 0.3, 0.3]))[1]
    targets = [np.asarray(p[3])[None], (np.asarray(p[1]) + np.array([0.5, 0.0, 0.5]))[None]]
    levels = [[(3, (0, 0, 0))], [(1, (0, 0, 0))]]
    _, errs = _hik_case(HierarchicalIK(m, levels, iters=80), JHierarchicalIK(jm, levels, iters=80),
                        targets, 4)
    assert float(errs[0, 0]) < 1e-4 and float(errs[0, 1]) > 0.1


def test_offsets_and_multi_task_level():
    m, jm = pair(5)
    off = (0.0, 0.0, 0.15)
    R, p = jax_fk(jm, jnp.array([0.2, -0.2, 0.4, -0.1, 0.3]))
    targets = [np.stack([np.asarray(jax_tf_apply(R[4], p[4], jnp.asarray(off))), np.asarray(p[2])])]
    levels = [[(4, off), (2, (0, 0, 0))]]
    _, errs = _hik_case(HierarchicalIK(m, levels, iters=100), JHierarchicalIK(jm, levels, iters=100),
                        targets, 5)
    assert float(errs[0, 0]) < 1e-3


def test_batched_targets():
    """Per-env targets (B, n_tasks, 3): each of B = 3 envs reaches its own."""
    B = 3
    m, _ = pair(4)
    rng = np.random.RandomState(7)
    from diffdart_tpu_torch.dynamics.kinematics import fk

    q_true = torch.tensor(0.4 * rng.randn(B, 4))
    targets = fk(m, q_true)[1][:, 3]
    hik = HierarchicalIK(m, [[(3, (0, 0, 0))]], iters=80)
    q, errs = hik.solve([targets[:, None]], torch.zeros(B, 4, dtype=F64))
    assert float(errs.max()) < 1e-6
    close(fk(m, q)[1][:, 3], targets, 1e-6)
