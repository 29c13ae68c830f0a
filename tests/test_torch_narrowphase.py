"""Primitive narrowphase of the torch port (diffdart_tpu_torch/collision/
narrowphase.py) and the pair dispatch of collision/collide.py against the
JAX package, float64 on the CPU.

Each pair function runs batched over B poses against jit(vmap(...)) of the
JAX function on the same numpy inputs: the first envs degenerate (parallel
axes, aligned boxes, a sphere centred on an axis or inside a solid), then
envs that just touch, then seeded random poses near contact. Positions,
normals and depths within 1e-12 absolute, validity exact. Then the whole
contact buffer of a scene holding every geom type (collide_world_with_bodies)
and of the catapult, against the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.collision import collide as JC
from diffdart_tpu.collision import narrowphase as JNP
from diffdart_tpu.dynamics import dynamics as JD
from diffdart_tpu_torch.collision import collide as C
from diffdart_tpu_torch.collision import narrowphase as NP
from diffdart_tpu_torch.dynamics import dynamics as D
from diffdart_tpu_torch.dynamics.model import GeomType, JointType, ModelBuilder
from diffdart_tpu_torch.models import catapult, catapult_init_q

from test_torch_convex import _check, _rots
from test_torch_vmap_dynamics import T, jax_model_of

B = 24
ND = 4  # degenerate envs first, then ND touching ones, then random


def _poses(seed, spread, rot_a=3.0, rot_b=3.0):
    rng = np.random.RandomState(seed)
    Ra, Rb = _rots(seed, rot_a), _rots(seed + 1, rot_b)
    pa = rng.uniform(-spread, spread, size=(B, 3))
    pb = rng.uniform(-spread, spread, size=(B, 3)) * 0.2
    Ra[:ND] = Rb[:ND] = np.eye(3)  # aligned / parallel axes
    return Ra, pa, Rb, pb


def _sizes(a, b):
    return np.tile(np.asarray(a, float), (B, 1)), np.tile(np.asarray(b, float), (B, 1))


def _case(name):
    """(Ra, pa, sa, Rb, pb, sb) numpy, B envs."""
    if name == "sphere_sphere":
        Ra, pa, Rb, pb = _poses(0, 0.2)
        sa, sb = _sizes([0.05, 0, 0], [0.08, 0, 0])
        pa[:ND] = pb[:ND] + [[0, 0, 0], [1e-12, 0, 0], [0.1, 0, 0], [0, 0.2, 0]]  # coincident centres
        d = np.random.RandomState(1).randn(ND, 3)
        pa[ND:2 * ND] = pb[ND:2 * ND] + 0.13 * d / np.linalg.norm(d, axis=1, keepdims=True)  # touching
    elif name == "sphere_box":
        Ra, pa, Rb, pb = _poses(2, 0.25)
        sa, sb = _sizes([0.05, 0, 0], [0.1, 0.15, 0.08])
        pa[:ND] = pb[:ND] + [[0, 0, 0], [0.09, 0, 0], [0, 0.149, 0.079], [0.1, 0.15, 0.08]]
        pa[ND:2 * ND] = pb[ND:2 * ND] + [[0.15, 0, 0], [0, -0.2, 0], [0, 0, 0.13], [0.11, 0.16, 0.09]]
    elif name == "sphere_capsule":
        Ra, pa, Rb, pb = _poses(3, 0.3)
        sa, sb = _sizes([0.05, 0, 0], [0.04, 0.15, 0])
        pa[:ND] = pb[:ND] + [[0, 0, 0], [0, 0, 0.1], [0, 0, 0.3], [0, 0, -0.19]]  # on the axis
        pa[ND:2 * ND] = pb[ND:2 * ND] + [[0.09, 0, 0], [0, 0.09, 0.15], [0, 0, 0.24], [0.09, 0, -0.1]]
    elif name == "sphere_cylinder":
        Ra, pa, Rb, pb = _poses(4, 0.3)
        sa, sb = _sizes([0.05, 0, 0], [0.1, 0.15, 0])
        pa[:ND] = pb[:ND] + [[0, 0, 0], [0, 0, 0.12], [0, 0, 0.2], [0.02, 0, 0.149]]  # on the axis
        pa[ND:2 * ND] = pb[ND:2 * ND] + [[0.15, 0, 0], [0, 0, 0.2], [0, 0.15, -0.1], [0.1, 0, 0.2]]
    elif name == "capsule_capsule":
        Ra, pa, Rb, pb = _poses(5, 0.3)
        sa, sb = _sizes([0.04, 0.2, 0], [0.05, 0.15, 0])
        pa[:ND] = pb[:ND] + [[0, 0, 0], [0.05, 0, 0.1], [0.09, 0, 0.3], [0, 0.1, -0.2]]  # parallel axes
        Rb[ND:2 * ND] = _rots(6, 0.0)[:ND]
        Ra[ND:2 * ND] = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]])  # crossed, touching
        pa[ND:2 * ND] = pb[ND:2 * ND] + [[0.09, 0, 0], [0.0899, 0, 0.05], [0.091, 0, 0], [-0.09, 0, 0.1]]
    elif name == "capsule_box":
        Ra, pa, Rb, pb = _poses(7, 0.3)
        sa, sb = _sizes([0.04, 0.2, 0], [0.1, 0.15, 0.08])
        pa[:ND] = pb[:ND] + [[0, 0, 0.1], [0.13, 0, 0], [0, 0.18, 0.1], [0.12, 0.17, 0.3]]  # axis || z
        pa[ND:2 * ND] = pb[ND:2 * ND] + [[0.14, 0, 0], [0, 0.19, 0], [0, 0, 0.32], [0.14, 0.19, 0.2]]
    elif name == "cylinder_plane":
        Ra, pa, Rb, pb = _poses(8, 0.2, rot_b=0.0)
        Rb[:] = np.eye(3)
        sa, sb = _sizes([0.1, 0.15, 0], [0, 0, 0])
        Ra[ND // 2:ND] = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]])  # lying: axis in the plane
        pa[:, 2] = pb[:, 2] + np.r_[0.14, 0.15, 0.09, 0.1, 0.15, 0.16, 0.1, 0.2,
                                    np.random.RandomState(9).uniform(0.0, 0.2, B - 2 * ND)]
    elif name == "box_box":
        Ra, pa, Rb, pb = _poses(10, 0.25, rot_a=1.0, rot_b=1.0)
        sa, sb = _sizes([0.1, 0.15, 0.08], [0.12, 0.1, 0.05])
        pa[:ND] = pb[:ND] + [[0, 0, 0.12], [0.05, 0.02, 0.125], [0.21, 0, 0], [0, 0, 0]]  # aligned
        pa[ND:2 * ND] = pb[ND:2 * ND] + [[0, 0, 0.13], [0.22, 0, 0], [0, 0.25, 0.02], [0.22, 0.25, 0.13]]
    return Ra, pa, sa, Rb, pb, sb


PAIRS = ["sphere_sphere", "sphere_box", "sphere_capsule", "sphere_cylinder", "capsule_capsule",
         "capsule_box", "cylinder_plane", "box_box"]


@pytest.mark.parametrize("name", PAIRS)
def test_pair_matches_jax(name):
    args = _case(name)
    want = jax.jit(jax.vmap(getattr(JNP, name)))(*args)
    got = getattr(NP, name)(*(T(x) for x in args))
    _check(got, want)
    assert bool(got[3].any()) and not bool(got[3].all()), "the poses should cover contact and none"


def _zoo():
    """A scene with every geom type on free bodies above a plane, every pair
    in contact range (31 pairs through every dispatch entry)."""
    b = ModelBuilder(dt=1e-3)
    b.add_geom(-1, GeomType.PLANE, friction=0.7)
    hull = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]) * [0.06, 0.05, 0.04]
    geoms = [(GeomType.SPHERE, (0.06, 0, 0)), (GeomType.BOX, (0.06, 0.05, 0.04)),
             (GeomType.CAPSULE, (0.04, 0.06, 0)), (GeomType.CYLINDER, (0.05, 0.05, 0)),
             (GeomType.ELLIPSOID, (0.06, 0.05, 0.04)), (GeomType.CONVEX, None),
             (GeomType.SPHERE, (0.05, 0, 0)), (GeomType.CYLINDER, (0.04, 0.06, 0))]
    for i, (gt, size) in enumerate(geoms):
        body = b.add_body(parent=-1, jtype=JointType.FREE, mass=1.0, inertia=np.eye(3) * 1e-3)
        if gt == GeomType.CONVEX:
            b.add_geom(body, gt, verts=hull, friction=0.5 + 0.05 * i, restitution=0.1)
        else:
            b.add_geom(body, gt, size=size, friction=0.5 + 0.05 * i, restitution=0.1)
    m = b.finalize(dtype=torch.float64, device="cpu")
    # keep the pairs some dispatch entry covers (the ellipsoid has only its
    # plane and sphere pairs)
    E = GeomType.ELLIPSOID
    pairs = tuple(p for p in m.col_pairs
                  if E not in (m.geom_type[p[0]], m.geom_type[p[1]])
                  or {m.geom_type[p[0]], m.geom_type[p[1]]} <= {E, GeomType.PLANE, GeomType.SPHERE})
    return m.replace(col_pairs=pairs)


@pytest.mark.parametrize("scene", ["zoo", "catapult"])
def test_collide_world_matches_jax(scene):
    if scene == "zoo":
        m = _zoo()
        rng = np.random.RandomState(11)
        q = np.tile(m.neutral_q().numpy(), (6, 1))
        for i in range(m.nbody):
            quat = rng.randn(6, 4)
            q[:, 7 * i:7 * i + 4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
            q[:, 7 * i + 4:7 * i + 7] = rng.uniform(-0.06, 0.06, (6, 3)) + [0, 0, 0.05]
    else:
        m = catapult(dtype=torch.float64, device="cpu")
        q = np.tile(catapult_init_q(m).numpy(), (6, 1))
        q[:, :2] += np.random.RandomState(12).uniform(-0.3, 0.3, (6, 2))
        q[:, 8] -= np.linspace(0.0, 0.02, 6)  # the ball into the cradle
    v = np.zeros((6, m.nv))
    jm = jax_model_of(m)

    def one(q, v):
        c = JD.kinematics_cache(jm, q, v)
        return JC.collide_world_with_bodies(jm, c["R"], c["p"])

    want, wa, wb = jax.jit(jax.vmap(one))(jnp.asarray(q), jnp.asarray(v))
    cache = D.kinematics_cache(m, T(q), T(v))
    got, ga, gb = C.collide_world_with_bodies(m, cache["R"], cache["p"])
    _check(got, want)
    for field in ("friction", "restitution"):
        np.testing.assert_array_equal(getattr(got, field).expand_as(got.depth).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa)[0])
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb)[0])
    assert C.contact_slots(m) == JC.contact_slots(jm)
    assert C.max_contacts(m) == JC.max_contacts(jm)
    assert bool(got.valid.any())
