"""The AABB pair-budget broadphase (Model.pair_budget) on the torch port's
vmap stack (diffdart_tpu_torch/collision/collide.py) against the JAX
package, float64 on the CPU.

The scene is tests/test_broadphase.py's field of free spheres over a plane
(n sphere-plane pairs, n (n - 1) / 2 sphere-sphere pairs). Checked: the
slot accounting; each env's kept pairs, in order, and their contacts and
body indices against jit(vmap(...)) of the JAX collision at states with
exact score ties (bit for bit on the order, 1e-12 on the contacts); the
JAX package's gate, a budgeted rollout equal to the full plan's while the
scene is sparse (atol 1e-9); gradients through the budgeted collision,
equal to the full plan's; contact_slots' raise under a budget.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.collision.collide import collide_world_with_bodies as jax_collide
from diffdart_tpu.collision.collide import max_contacts as jax_max_contacts
from diffdart_tpu.dynamics import dynamics as JD
from diffdart_tpu_torch.collision import collide as C
from diffdart_tpu_torch.dynamics import dynamics as D
from diffdart_tpu_torch.dynamics.model import GeomType, JointType, ModelBuilder, State
from diffdart_tpu_torch.sim.step import rollout, rollout_final

from test_torch_vmap_dynamics import T, close, jax_model_of


def sphere_field(n=8, budget=0):
    b = ModelBuilder(dt=2e-3)
    for i in range(n):
        bi = b.add_body(parent=-1, jtype=JointType.FREE, mass=0.5, inertia=np.eye(3) * 0.002,
                        name=f"s{i}")
        b.add_geom(bi, GeomType.SPHERE, size=(0.1, 0, 0), friction=0.5)
    b.add_geom(-1, GeomType.PLANE, friction=0.5)
    m = b.finalize(dtype=torch.float64, device="cpu")
    return m.replace(pair_budget=budget) if budget else m


def grid_q(n, spacing=1.0):
    q = []
    for i in range(n):
        q += [1.0, 0, 0, 0, (i % 3) * spacing, (i // 3) * spacing, 0.15 + 0.015 * i]
    return np.array(q)


def test_slot_accounting():
    n = 8
    full, bud = sphere_field(n), sphere_field(n, budget=4)
    assert C.max_contacts(full) == n * (n - 1) // 2 + n == jax_max_contacts(jax_model_of(full))
    assert C.max_contacts(bud) == 4 + 4 == jax_max_contacts(jax_model_of(bud))
    assert C.effective_contacts(bud) == 8


def _crowded_states(n, B=6, seed=0):
    """Spheres packed near each other and the plane, with exact score ties:
    env 0 puts every sphere at one height (plane scores tie) and env 1
    places pairs at equal distances (sphere-sphere scores tie)."""
    rng = np.random.RandomState(seed)
    q = np.tile(grid_q(n, spacing=0.25), (B, 1)).reshape(B, n, 7)
    q[:, :, 4:7] += 0.05 * rng.randn(B, n, 3)
    q[0, :, 6] = 0.12
    q[1, :, 4] = 0.19 * np.arange(n)
    q[1, :, 5] = 0.0
    return q.reshape(B, n * 7)


def test_kept_pairs_and_contacts_match_jax():
    n = 8
    m = sphere_field(n, budget=4)
    jm = jax_model_of(m)
    q = _crowded_states(n)
    v = np.zeros((q.shape[0], m.nv))

    def one(q, v):
        c = JD.kinematics_cache(jm, q, v)
        return jax_collide(jm, c["R"], c["p"])

    want, wa, wb = jax.jit(jax.vmap(one))(jnp.asarray(q), jnp.asarray(v))
    cache = D.kinematics_cache(m, T(q), T(v))
    got, ga, gb = C.collide_world_with_bodies(m, cache["R"], cache["p"])
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    for f in ("pos", "normal", "depth", "friction", "restitution"):
        close(getattr(got, f), getattr(want, f), atol=1e-12, msg=f)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid[:, :4].any() and got.valid[:, 4:].any()  # sphere-sphere and plane slots
    assert C.collide_world(m, cache["R"], cache["p"]).depth.shape == got.depth.shape


def test_budgeted_matches_full_while_sparse():
    """The JAX package's gate (tests/test_broadphase.py:57): spheres spread
    out, two launched at each other so one sphere-sphere contact forms
    mid-trajectory; a budget of 6 culls only pairs that make no contact,
    so the 100-step trajectory equals the full plan's."""
    n = 6
    full, bud = sphere_field(n), sphere_field(n, budget=6)
    q0 = grid_q(n)
    q0[7 + 4] = 0.35
    v0 = np.zeros(full.nv)
    v0[3], v0[6 + 3] = 0.8, -0.8
    s0 = State(q=T(q0[None]), v=T(v0[None]))
    taus = torch.zeros(100, 1, full.nv, dtype=torch.float64)
    with torch.no_grad():
        _, tr_full = rollout(full, s0, taus)
        _, tr_bud = rollout(bud, s0, taus)
    np.testing.assert_allclose(tr_bud.q.numpy(), tr_full.q.numpy(), atol=1e-9)
    z = tr_full.q[-1, 0].reshape(n, 7)[:, 6].numpy()
    assert np.all(np.abs(z - 0.1) < 2e-2), z


def test_gradients_flow_through_budgeted_collision():
    """d x_final / d vx of the pushed sphere through 30 budgeted steps:
    finite, responsive, and equal to the full plan's (the culled pairs
    make no contact)."""
    n = 5
    q0 = T(grid_q(n)[None])

    def grad(m):
        vx = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
        v = torch.zeros(1, m.nv, dtype=torch.float64)
        v = torch.cat([v[:, :3], vx.reshape(1, 1), v[:, 4:]], dim=1)
        fin = rollout_final(m, State(q=q0, v=v), torch.zeros(30, 1, m.nv, dtype=torch.float64))
        (g,) = torch.autograd.grad(fin.q[0, 4], vx)
        return float(g)

    g_bud, g_full = grad(sphere_field(n, budget=4)), grad(sphere_field(n))
    assert np.isfinite(g_bud) and abs(g_bud) > 1e-4
    np.testing.assert_allclose(g_bud, g_full, rtol=1e-9)


def test_contact_slots_raises_under_budget():
    with pytest.raises(ValueError, match="pair_budget"):
        C.contact_slots(sphere_field(8, budget=4))
    assert len(C.contact_slots(sphere_field(8, budget=99))[0]) == 36
