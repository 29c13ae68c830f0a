"""Collision and constraint assembly of the torch port's vmap stack
(collision/narrowphase.py, collision/collide.py, constraints/assembly.py)
against the JAX package, float64 on the CPU: the contact buffers
(collide_world_with_bodies) and the assembled LCP (LCPData, from
sim/constrained.py::prepare_constrained) field by field, on half-cheetah,
jump_worm(n_links=2) and cube_drop states that are in contact, each against
jit(vmap(...)) of the JAX code on the same numpy inputs.

Tolerance 1e-10 absolute on every float field (A's entries reach ~1e2 on
the cube; the two packages sum J Minv J^T in other orders, ~1e-13 apart),
exact on the masks, the friction index and the slot layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.collision.collide import collide_world_with_bodies as jax_collide
from diffdart_tpu.collision.collide import contact_slots as jax_contact_slots
from diffdart_tpu.constraints.assembly import static_fidx as jax_static_fidx
from diffdart_tpu.constraints.assembly import tangent_basis as jax_tangent_basis
from diffdart_tpu.dynamics import dynamics as JD
from diffdart_tpu.dynamics.model import State as JState
from diffdart_tpu.sim.constrained import prepare_constrained as jax_prepare
from diffdart_tpu_torch.collision import collide as C
from diffdart_tpu_torch.constraints.assembly import static_fidx, tangent_basis
from diffdart_tpu_torch.dynamics import dynamics as D
from diffdart_tpu_torch.dynamics.model import GeomType, JointType, ModelBuilder, State
from diffdart_tpu_torch.sim.constrained import prepare_constrained

from test_torch_vmap_dynamics import T, batch, close

CASES = ["half_cheetah", "worm", "cube_drop"]


@pytest.fixture(scope="module")
def ref():
    """name -> (port model, q, v, tau, JAX contacts, JAX LCPData)."""
    cache = {}

    def get(name):
        if name not in cache:
            m, jm, q, v, tau = batch(name, seed=1)

            def one(q, v, tau):
                c = JD.kinematics_cache(jm, q, v)
                contacts, ba, bb = jax_collide(jm, c["R"], c["p"])
                lcp = jax_prepare(jm, JState(q=q, v=v, t=jnp.zeros(())), tau)[0]
                return contacts, ba, bb, lcp

            out = jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in (q, v, tau)))
            cache[name] = (m, q, v, tau, *out)
        return cache[name]

    return get


@pytest.mark.parametrize("name", CASES)
def test_contacts_match_jax(name, ref):
    m, q, v, tau, contacts, ba, bb, _ = ref(name)
    cache = D.kinematics_cache(m, T(q), T(v))
    got, ga, gb = C.collide_world_with_bodies(m, cache["R"], cache["p"])
    for field in ("pos", "normal", "depth"):
        close(getattr(got, field), getattr(contacts, field), atol=1e-12, msg=field)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(contacts.valid))
    for field in ("friction", "restitution"):
        close(getattr(got, field).expand_as(got.depth), getattr(contacts, field), msg=field)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ba)[0])
    np.testing.assert_array_equal(gb.numpy(), np.asarray(bb)[0])
    assert got.valid.any(), "the test states should be in contact"


@pytest.mark.parametrize("name", CASES)
def test_lcp_data_matches_jax(name, ref):
    m, q, v, tau, _, _, _, lcp = ref(name)
    got = prepare_constrained(m, State(q=T(q), v=T(v)), T(tau))[0]
    for field in ("J", "A", "b", "lo", "hi", "mu"):
        close(getattr(got, field), getattr(lcp, field), atol=1e-10, msg=field)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(lcp.valid))
    np.testing.assert_array_equal(got.fidx.numpy(), np.asarray(lcp.fidx)[0])
    assert static_fidx(m) == jax_static_fidx(_jm(name))


def _jax_model(m):
    from test_torch_vmap_dynamics import jax_model_of

    return jax_model_of(m)


def _jm(name):
    from test_torch_vmap_dynamics import jax_model_of

    return jax_model_of(batch(name)[0])


@pytest.mark.parametrize("name", CASES)
def test_slot_layout_matches_jax(name):
    m = batch(name)[0]
    jm = _jm(name)
    assert C.contact_slots(m) == jax_contact_slots(jm)
    assert C.max_contacts(m) == len(C.contact_slots(m)[0])


def test_tangent_basis_matches_jax():
    n = np.random.RandomState(3).randn(16, 3)
    n[:4] = np.eye(3)[[0, 1, 2, 2]] * np.r_[1, -1, 1, -1][:, None]  # axis-aligned ties
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    t1j, t2j = jax.jit(jax_tangent_basis)(jnp.asarray(n))
    t1, t2 = tangent_basis(T(n))
    close(t1, t1j)
    close(t2, t2j)


def test_unported_pairs_and_budgets_raise():
    """The cylinder-plane pair, a contact budget below the slot count and
    the pair_budget broadphase raised here until they were ported; on the
    same inputs they now run: the cylinder's 8 rim slots equal the JAX
    package's, a budget of 1 keeps one slot, and a pair budget of 1 keeps
    one of the worm's two capsule-plane pairs per env, its contacts equal
    to the JAX package's."""
    b = ModelBuilder(dt=1e-3)
    b.add_geom(-1, GeomType.PLANE)
    body = b.add_body(parent=-1, jtype=JointType.FREE)
    b.add_geom(body, GeomType.CYLINDER, size=(0.1, 0.1, 0))
    m = b.finalize(dtype=torch.float64, device="cpu")
    assert C.max_contacts(m) == 8
    q = m.neutral_q().numpy()
    q[4:7] = (0.01, -0.02, 0.09)  # 1 cm into the ground
    q[:4] = np.r_[1.0, 0.1, 0.05, 0.0] / np.linalg.norm([1.0, 0.1, 0.05, 0.0])  # tilted
    cache = D.kinematics_cache(m, T(q[None]), torch.zeros(1, m.nv, dtype=torch.float64))
    got, ga, gb = C.collide_world_with_bodies(m, cache["R"], cache["p"])
    jc = JD.kinematics_cache(_jax_model(m), jnp.asarray(q), jnp.zeros(m.nv))
    want, wa, wb = jax_collide(_jax_model(m), jc["R"], jc["p"])
    for field in ("pos", "normal", "depth"):
        close(getattr(got, field)[0], getattr(want, field), atol=1e-12, msg=field)
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(want.valid))
    assert got.valid.any()
    worm = batch("worm")[0]
    from diffdart_tpu.collision.collide import max_contacts as jax_max_contacts

    pb = worm.replace(pair_budget=1)
    assert C.max_contacts(pb) == jax_max_contacts(_jax_model(pb)) < C.max_contacts(worm)
    wq, wv = batch("worm")[2:4]
    wc = D.kinematics_cache(pb, T(wq), T(wv))
    got_pb, ga_pb, _ = C.collide_world_with_bodies(pb, wc["R"], wc["p"])
    jpb = _jax_model(pb)
    for i in range(len(wq)):
        jc_i = JD.kinematics_cache(jpb, jnp.asarray(wq[i]), jnp.asarray(wv[i]))
        want_i, wa_i, _ = jax_collide(jpb, jc_i["R"], jc_i["p"])
        close(got_pb.depth[i], want_i.depth, atol=1e-12, msg="pair-budget depth")
        np.testing.assert_array_equal(ga_pb[i].numpy(), np.asarray(wa_i))
    assert C.effective_contacts(worm.replace(contact_budget=1)) == 1
    cache = D.kinematics_cache(worm, T(batch("worm")[2]), T(batch("worm")[3]))
    one = C.select_contacts(worm.replace(contact_budget=1),
                            *C.collide_world_with_bodies(worm, cache["R"], cache["p"]))
    assert one[0].depth.shape[-1] == 1 and one[1].shape == one[0].depth.shape
    assert C.effective_contacts(worm.replace(contact_budget=99)) == C.max_contacts(worm)
