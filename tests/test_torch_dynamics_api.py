"""The rest of the port's public dynamics and collision API against the
JAX package, float64 on the CPU, eager calls (no rollouts): forward and
inverse dynamics and their round trip, the two energies, the explicit
joint forces, the bodies' and the mechanism's centres of mass
(diffdart_tpu_torch/dynamics/), collide_world (collision/collide.py) and
the LCP's solve residual (ops/lcp_pivot.py), on cart-pole, the
half-cheetah (feet on the floor) and the Atlas-class humanoid.

The JAX references are one jit(vmap(...)) per model, every function in one
program, in a module-scoped fixture. Tolerance 1e-10
absolute, scaled by the largest magnitude of the field (the mass matrices
sum in other orders); the round trip inverse(forward(tau)) = tau to 1e-9
of max |tau|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.collision.collide import collide_world as jax_collide_world
from diffdart_tpu.dynamics import dynamics as JD
from diffdart_tpu.dynamics import kinematics as JK
from diffdart_tpu.ops.lcp_pivot import solve_residual as jax_solve_residual
from diffdart_tpu_torch import dynamics as dyn_pkg
from diffdart_tpu_torch.collision import collide_world
from diffdart_tpu_torch.dynamics import dynamics as D
from diffdart_tpu_torch.dynamics import kinematics as K
from diffdart_tpu_torch.models import cartpole, cheetah_init_q, half_cheetah, humanoid, humanoid_init_q
from diffdart_tpu_torch.ops.lcp_pivot import solve_residual
from diffdart_tpu_torch.sim.constrained import prepare_constrained
from diffdart_tpu_torch.dynamics.model import JointType, State

from test_torch_vmap_dynamics import T, jax_model_of

F64 = dict(dtype=torch.float64, device="cpu")


def _cartpole():
    m = cartpole(dt=0.01, **F64)
    return m, np.array([0.1, 3.0])


def _cheetah():
    m = half_cheetah(dt=2e-3, **F64)
    return m, cheetah_init_q(m).numpy() - np.r_[0.25, np.zeros(m.nq - 1)]


def _humanoid():
    m = humanoid(**F64)
    q0 = humanoid_init_q(m).numpy().copy()
    q0[6] -= 0.005
    return m, q0


BUILDERS = {"cartpole": _cartpole, "half_cheetah": _cheetah, "humanoid": _humanoid}


def _jax_all(jm):
    """Every reference of one env, one program per model."""

    def one(q, v, tau):
        qdd = JD.forward_dynamics(jm, q, v, tau)
        R, p = JK.fk(jm, q)
        c = jax_collide_world(jm, R, p)
        return dict(qdd=qdd, tau=JD.inverse_dynamics(jm, q, v, qdd),
                    jf=JD.joint_forces(jm, q, v),
                    ke=JD.kinetic_energy(jm, q, v), pe=JD.potential_energy(jm, q),
                    coms=JK.com_positions(jm, R, p), com=JK.total_com(jm, R, p),
                    pos=c.pos, normal=c.normal, depth=c.depth, valid=c.valid)

    return jax.jit(jax.vmap(one))


@pytest.fixture(scope="module")
def cases():
    """name -> (port model, q, v, tau, f_ext, the JAX references)."""
    cache = {}

    def get(name):
        if name not in cache:
            m, q0 = BUILDERS[name]()
            B = 2
            rng = np.random.RandomState(3)
            q = np.tile(q0, (B, 1))
            scalar = np.ones(m.nq, bool)  # the quaternions keep their values
            for i in range(m.nbody):
                if m.jtype[i] in (JointType.FREE, JointType.BALL):
                    scalar[m.q_off[i]:m.q_off[i] + 4] = False
            q[:, scalar] += 0.03 * rng.randn(B, int(scalar.sum()))
            v = 0.3 * rng.randn(B, m.nv)
            tau = rng.randn(B, m.nv)
            f_ext = 0.5 * np.ones_like(tau)
            ref = _jax_all(jax_model_of(m))(*(jnp.asarray(x) for x in (q, v, tau)))
            cache[name] = (m, q, v, tau, f_ext, ref)
        return cache[name]

    return get


def near(got, want, atol=1e-10, msg=""):
    want = np.asarray(want)
    got = got.detach().numpy()
    np.testing.assert_allclose(got, want, atol=atol * max(1.0, float(np.abs(want).max())), rtol=0,
                               err_msg=msg)


@pytest.mark.parametrize("name", list(BUILDERS))
def test_forward_inverse_dynamics_and_joint_forces(name, cases):
    m, q, v, tau, f_ext, ref = cases(name)
    qdd = D.forward_dynamics(m, T(q), T(v), T(tau))
    near(qdd, ref["qdd"], msg="qdd")
    near(dyn_pkg.inverse_dynamics(m, T(q), T(v), qdd), ref["tau"], msg="tau")
    near(D.inverse_dynamics(m, T(q), T(v), qdd), tau, atol=1e-9, msg="round trip")
    near(D.joint_forces(m, T(q), T(v)), ref["jf"], msg="joint forces")
    # f_ext adds to the generalised force (one unrolled solve less to compile)
    near(dyn_pkg.forward_dynamics(m, T(q), T(v), T(tau), f_ext=T(f_ext)),
         D.forward_dynamics(m, T(q), T(v), T(tau + f_ext)).numpy(), msg="f_ext")


@pytest.mark.parametrize("name", list(BUILDERS))
def test_energies_and_centres_of_mass(name, cases):
    m, q, v, tau, f_ext, ref = cases(name)
    near(D.kinetic_energy(m, T(q), T(v)), ref["ke"], msg="kinetic")
    near(D.potential_energy(m, T(q)), ref["pe"], msg="potential")
    R, p = K.fk(m, T(q))
    near(K.com_positions(m, R, p), ref["coms"], msg="com_positions")
    near(K.total_com(m, R, p), ref["com"], msg="total_com")


@pytest.mark.parametrize("name", ["half_cheetah", "humanoid"])
def test_collide_world_and_solve_residual(name, cases):
    m, q, v, tau, f_ext, ref = cases(name)
    R, p = K.fk(m, T(q))
    got = collide_world(m, R, p)
    for f in ("pos", "normal", "depth"):
        near(getattr(got, f), ref[f], atol=1e-12, msg=f)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref["valid"]))
    assert got.valid.any()
    lcp = prepare_constrained(m, State(q=T(q), v=T(v)), T(tau))[0]
    lam = torch.tensor(np.abs(np.random.RandomState(0).randn(*lcp.b.shape)))
    res = solve_residual(lam, lcp.A, lcp.b, lcp.lo, lcp.hi, lcp.mu, lcp.fidx)
    fidx = jnp.asarray(lcp.fidx.numpy())
    want = [jax_solve_residual(*(jnp.asarray(x[i].detach().numpy()) for x in
                                 (lam, lcp.A, lcp.b, lcp.lo, lcp.hi, lcp.mu)), fidx)
            for i in range(len(q))]
    near(res, np.stack([np.asarray(w) for w in want]))
    assert float(res.max()) > 0.0
