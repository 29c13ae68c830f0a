"""Timestep Jacobians of the torch port (neural/jacobians.py) against the JAX
package (diffdart_tpu/neural/jacobians.py), env by env, float64 on the CPU,
B = 3 envs per state, the same numpy inputs on both sides:
timestep_jacobians (all seven blocks), backprop with a random LossGradient,
and jacobian_wrt for each of its six parameters.

* Contact-free (double pendulum, cartpole; tests/test_neural.py's states
  with small per-env offsets): rtol 1e-9, atol 1e-10, the same formulas in
  another order.
* With contact (cube_drop resting and sliding, tests/test_neural.py:84-92's
  states): on the envs whose LCP converged (natural-map residual below
  1e-8, tests/test_tilestep.py:103-126's criterion), rtol 1e-6 plus atol
  1e-8 times each block's largest magnitude (ops/vjp_check.py's limits:
  the Woodbury solve amplifies rounding by about eps/cfm).
The port's models run contact_solver='lowrank_pallas', which takes the
plain sweeps on CPU tensors; each state's JAX reference is one jitted
program per function, and the two cube states share it (the model is its
argument).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.dynamics.model import State as JState
from diffdart_tpu.neural import LossGradient as JLossGradient
from diffdart_tpu.neural import backprop as jax_backprop
from diffdart_tpu.neural import jacobian_wrt as jax_jacobian_wrt
from diffdart_tpu.neural import timestep_jacobians as jax_timestep_jacobians
from diffdart_tpu_torch.dynamics.model import State
from diffdart_tpu_torch.models import cartpole, cube_drop, double_pendulum
from diffdart_tpu_torch.neural import LossGradient, backprop, jacobian_wrt, timestep_jacobians
from diffdart_tpu_torch.ops.vjp_check import VJP_ATOL, VJP_RTOL
from diffdart_tpu_torch.sim.constrained import solver_diagnostics

from test_torch_vmap_dynamics import T, close, jax_model_of

F64 = dict(dtype=torch.float64, device="cpu")
B = 3
WRT = ("position", "velocity", "force", "group_masses", "group_coms", "group_inertias")
BLOCKS = ("pos_pos", "pos_vel", "vel_pos", "vel_vel", "force_pos", "force_vel", "mass_vel")


def _cube(friction, v0):
    def build():
        m = cube_drop(dt=2e-3, half=0.1, friction=friction, **F64).replace(contact_solver="lowrank_pallas")
        q = m.neutral_q().numpy()
        q[6] = 0.09995
        v = np.zeros(6)
        v[3] = v0
        return m, q, v, np.zeros(6), (1e-3, 1e-5, 1e-2)
    return build


# name -> () -> (port model, q, v, tau, (noise of the quaternion, of the
# other q entries, of v))
STATES = {
    "double_pendulum": lambda: (double_pendulum(dt=5e-3, **F64), np.array([0.4, -0.7]),
                                np.array([1.0, -2.0]), np.array([0.3, -0.1]), (0, 0.05, 0.05)),
    "cartpole": lambda: (cartpole(dt=5e-3, **F64), np.array([0.1, 0.5]), np.array([-0.3, 0.8]),
                         np.array([0.5, 0.0]), (0, 0.05, 0.05)),
    "cube_resting": _cube(0.6, 0.0),
    "cube_sliding": _cube(0.4, 1.5),
}
CONTACT = {"cube_resting", "cube_sliding"}


def _batch(name):
    """(model, q, v, tau, next-step gradient) as (B, k) numpy."""
    m, q, v, tau, (nquat, nq, nv) = STATES[name]()
    rng = np.random.RandomState(len(name))
    qs = np.tile(q, (B, 1))
    mask = m.quat_dof_mask
    qs += np.where(mask, nquat, nq) * rng.randn(B, m.nq)
    vs = np.tile(v, (B, 1)) + nv * rng.randn(B, m.nv)
    grads = rng.randn(2, B, m.nv)
    return m, qs, vs, np.tile(tau, (B, 1)), grads


def _jax_fn(fn):
    """The JAX package's function `fn` ('timestep', 'backprop' or a wrt of
    jacobian_wrt) at (q, v, tau) of one env."""
    def one(jm, q, v, tau, gq, gv):
        s = JState(q=q, v=v, t=jnp.zeros(()))
        if fn == "timestep":
            return jax_timestep_jacobians(jm, s, tau)._asdict()
        if fn == "backprop":
            return jax_backprop(jm, s, tau, JLossGradient(gq, gv, jnp.zeros_like(tau)))._asdict()
        return jax_jacobian_wrt(jm, s, tau, fn)
    return one


# fn -> one jitted program over the envs (the model is an argument: the two
# cube states, which differ only in array fields, share each program)
_JAX = {fn: jax.jit(jax.vmap(_jax_fn(fn), in_axes=(None, 0, 0, 0, 0, 0)))
        for fn in ("timestep", "backprop", *WRT)}


@pytest.fixture(scope="module")
def refs():
    """(name, fn) -> (port model, inputs, converged envs, JAX result),
    each computed once."""
    cache = {}

    def get(name, fn):
        if name not in cache:
            m, q, v, tau, (gq, gv) = _batch(name)
            with torch.no_grad():
                res = solver_diagnostics(m, State(q=T(q), v=T(v)), T(tau)).numpy()
            conv = res < 1e-8 if name in CONTACT else np.ones(B, bool)
            assert conv.any(), f"no converged env: {res}"
            cache[name] = (m, jax_model_of(m), (q, v, tau, gq, gv), conv)
        m, jm, xs, conv = cache[name]
        if (name, fn) not in cache:
            out = _JAX[fn](jm, *(jnp.asarray(x) for x in xs))
            cache[name, fn] = jax.tree_util.tree_map(np.asarray, out)
        return m, xs, conv, cache[name, fn]

    return get


def _check(name, got, want, conv, what):
    got = got.detach().numpy()[conv]
    want = np.asarray(want)[conv]
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(want).all(), what
    if name in CONTACT:
        close(got, want, atol=VJP_ATOL * max(np.abs(want).max(), 1e-30), rtol=VJP_RTOL, msg=what)
    else:
        close(got, want, atol=1e-10, rtol=1e-9, msg=what)


@pytest.mark.parametrize("name", sorted(STATES))
def test_timestep_jacobians_match_jax(name, refs):
    m, (q, v, tau, _, _), conv, want = refs(name, "timestep")
    got = timestep_jacobians(m, State(q=T(q), v=T(v)), T(tau))
    for block in BLOCKS:
        _check(name, getattr(got, block), want[block], conv, block)
    assert got.mass_vel.shape == (B, m.nbody, m.nv)


@pytest.mark.parametrize("name", sorted(STATES))
def test_backprop_matches_jax(name, refs):
    m, (q, v, tau, gq, gv), conv, want = refs(name, "backprop")
    got = backprop(m, State(q=T(q), v=T(v)), T(tau),
                   LossGradient(T(gq), T(gv), torch.zeros(B, m.nv, dtype=torch.float64)))
    for f in ("wrt_position", "wrt_velocity", "wrt_torque"):
        _check(name, getattr(got, f), want[f], conv, f)


@pytest.mark.parametrize("wrt", WRT)
@pytest.mark.parametrize("name", sorted(STATES))
def test_jacobian_wrt_matches_jax(name, wrt, refs):
    m, (q, v, tau, _, _), conv, want = refs(name, wrt)
    got = jacobian_wrt(m, State(q=T(q), v=T(v)), T(tau), wrt)
    for part, g, w in zip(("position", "velocity"), got, want):
        _check(name, g, w, conv, f"{wrt} -> {part}")
