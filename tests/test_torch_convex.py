"""Convex-hull and ellipsoid narrowphase of the torch port
(diffdart_tpu_torch/collision/convex.py) and the contact budget's slot
selection (collision/collide.py::select_contacts) against the JAX package,
float64 on the CPU.

Each pair function runs batched over seeded poses (some penetrating, some
clear, some resting flat, where a hull's corners tie in depth) against
jit(vmap(...)) of the JAX function on the same numpy inputs: positions,
normals and depths within 1e-12 absolute, validity exact. The hulls are the
Atlas humanoid's (foot and pelvis), padded as the model pads them. On
constructed exact ties, the slots chosen and their order equal the JAX
package's (`jnp.argsort` and `lax.top_k`: the lower index first).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.collision import collide as JC
from diffdart_tpu.collision import convex as JX
from diffdart_tpu_torch.collision import collide as C
from diffdart_tpu_torch.collision import convex as X
from diffdart_tpu_torch.models import cube_drop, humanoid

from test_torch_vmap_dynamics import T, close, jax_model_of

B = 24


@functools.lru_cache(maxsize=None)
def _hulls():
    """{name: (verts, face_n, face_b, vmask, fmask)} as numpy, from the port's
    humanoid (float64, CPU): the foot (hull 2) and the pelvis (hull 0)."""
    m = humanoid(dtype=torch.float64, device="cpu")
    out = {}
    for name, g in (("pelvis", m.geom_hull.index(0)), ("foot", m.geom_hull.index(2))):
        out[name] = tuple(x.numpy() for x in C._hull_args(m, g))
    return out


def _J(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _rots(seed, tilt, flat=0):
    """B rotations about random axes by up to `tilt` rad; the first `flat`
    are the identity."""
    rng = np.random.RandomState(seed)
    w = rng.randn(B, 3)
    w *= (tilt * rng.rand(B, 1)) / np.linalg.norm(w, axis=1, keepdims=True)
    w[:flat] = 0.0
    th = np.linalg.norm(w, axis=1)[:, None, None]
    K = np.zeros((B, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
    K = K - K.transpose(0, 2, 1)
    safe = np.where(th > 0, th, 1.0)
    return (np.eye(3) + np.sin(th) / safe * K
            + (1 - np.cos(th)) / safe**2 * K @ K) * (th > 0) + np.eye(3) * (th == 0)


def _pos(seed, lo, hi):
    return np.random.RandomState(seed).uniform(lo, hi, size=(B, 3))


def _check(got, want):
    for field, a, b in zip(("pos", "normal", "depth"), got[:3], want[:3]):
        close(a, b, atol=1e-12, msg=field)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def _plane():
    return np.tile(np.eye(3), (B, 1, 1)), np.zeros((B, 3))


def _foot_floor_z(flat=8):
    """Foot poses against the ground: the first `flat` resting level 3 mm
    into the plane (its sole's corners tie), the rest tilted at random."""
    hv = _hulls()["foot"][0]
    R = _rots(1, 0.4, flat=flat)
    p = _pos(2, -0.05, 0.05)
    p[:, 2] = -hv[:, 2].min() - np.r_[np.full(flat, 3e-3), np.random.RandomState(3).uniform(
        -0.02, 0.03, B - flat)]
    return R, p


def test_convex_plane_matches_jax():
    hv, _, _, vmask, _ = _hulls()["foot"]
    Ra, pa = _foot_floor_z()
    Rb, pb = _plane()
    jv, jm_ = _J(hv, vmask)
    want = jax.jit(jax.vmap(lambda Ra, pa, Rb, pb: JX.convex_plane(Ra, pa, jv, jm_, Rb, pb)))(
        Ra, pa, Rb, pb)
    got = X.convex_plane(T(Ra), T(pa), T(hv), T(vmask), T(Rb), T(pb))
    _check(got, want)
    assert bool(got[3][:8].all()), "the level foot should touch at 4 corners"


@pytest.mark.parametrize("pair", ["sphere", "capsule"])
@pytest.mark.parametrize("hull", ["foot", "pelvis"])
def test_sphere_and_capsule_convex_match_jax(pair, hull):
    hv, hn, hb, _, fmask = _hulls()[hull]
    jh = _J(hv, hn, hb, fmask)
    Ra, Rb = _rots(4, 3.0), _rots(5, 3.0, flat=4)
    pa, pb = _pos(6, -0.15, 0.15), _pos(7, -0.02, 0.02)
    sa = np.tile([0.05, 0.1, 0.0], (B, 1))
    fn = {"sphere": (JX.sphere_convex, X.sphere_convex),
          "capsule": (JX.capsule_convex, X.capsule_convex)}[pair]
    want = jax.jit(jax.vmap(lambda Ra, pa, sa, Rb, pb: fn[0](Ra, pa, sa, Rb, pb, *jh)))(
        Ra, pa, sa, Rb, pb)
    got = fn[1](T(Ra), T(pa), T(sa), T(Rb), T(pb), T(hv), T(hn), T(hb), T(fmask))
    _check(got, want)
    assert bool(got[3].any()) and not bool(got[3].all())


def test_point_hull_depth_matches_jax():
    hv, hn, hb, _, fmask = _hulls()["pelvis"]
    c = _pos(8, -0.2, 0.2)
    c[:3] = 0.0  # the centre: several faces at one distance
    jh = _J(hv, hn, hb, fmask)
    want = jax.jit(jax.vmap(lambda c: JX.point_hull_depth(c, *jh)))(c)
    got = X.point_hull_depth(T(c), T(hv), T(hn), T(hb), T(fmask))
    close(got[0], want[0], atol=1e-12)
    close(got[1], want[1], atol=1e-12)


@pytest.mark.parametrize("a", ["foot", "box"])
@pytest.mark.parametrize("flat", [0, 12])
def test_convex_convex_matches_jax(a, flat):
    """Hull A (the foot, or a box as a hull) against hull B (the pelvis):
    tilted at random, or (flat) A level on B's top face, where the SAT
    axes and the manifold's depths tie."""
    hb_ = _hulls()["pelvis"]
    size = np.array([0.06, 0.04, 0.03])
    ha = _hulls()["foot"] if a == "foot" else tuple(
        np.asarray(x) for x in JX.box_as_hull(jnp.asarray(size), jnp.float64))
    Ra, Rb = _rots(9, 0.6, flat=flat), _rots(10, 0.6, flat=flat)
    pa = _pos(11, -0.05, 0.05)
    pb = np.zeros((B, 3))
    pa[:, 2] = hb_[0][:, 2].max() - ha[0][:, 2].min() - np.r_[
        np.full(flat, 4e-3), np.random.RandomState(12).uniform(-0.02, 0.05, B - flat)]
    ja, jb = _J(*ha), _J(*hb_)
    want = jax.jit(jax.vmap(lambda Ra, pa, Rb, pb: JX.convex_convex(Ra, pa, *ja, Rb, pb, *jb)))(
        Ra, pa, Rb, pb)
    got = X.convex_convex(T(Ra), T(pa), *(T(x) for x in ha), T(Rb), T(pb), *(T(x) for x in hb_))
    _check(got, want)
    assert bool(got[3].any())


def test_box_as_hull_matches_jax():
    size = np.array([0.1, 0.25, 0.05])
    for a, b in zip(X.box_as_hull(T(size), torch.float64), JX.box_as_hull(jnp.asarray(size),
                                                                          jnp.float64)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ellipsoid_pairs_match_jax():
    Ra, Rb = _rots(13, 3.0, flat=3), _rots(14, 3.0)
    radii = np.tile([0.1, 0.2, 0.05], (B, 1))
    pa = _pos(15, -0.1, 0.1)
    pa[:, 2] = np.random.RandomState(16).uniform(-0.05, 0.25, B)
    Rp, pp = _plane()
    args = (Ra, pa, radii, Rp, pp, radii)
    want = jax.jit(jax.vmap(JX.ellipsoid_plane))(*args)
    _check(X.ellipsoid_plane(*(T(x) for x in args)), want)
    # a sphere of radius 0.08 around the ellipsoid: outside, touching and inside
    sphere = np.tile([0.08, 0.0, 0.0], (B, 1))
    pc = _pos(17, -0.3, 0.3)
    pc[:4] = [[0.0, 0.0, 0.0], [0.0, 0.15, 0.0], [0.2, 0.0, 0.0], [0.0, 0.0, 0.12]]
    args = (Rb, pc, sphere, Ra, pa * 0, radii)
    want = jax.jit(jax.vmap(JX.sphere_ellipsoid))(*args)
    got = X.sphere_ellipsoid(*(T(x) for x in args))
    _check(got, want)
    assert bool(got[3].any()) and not bool(got[3].all())


# ---------------------------------------------------------------------------
# the k deepest slots on exact ties


def _tie_case(seed, n):
    """Depths drawn from 3 values (exact ties) with some slots invalid."""
    rng = np.random.RandomState(seed)
    depth = rng.choice([0.0, 1e-3, 2e-3], size=(B, n))
    valid = (depth > 0) & (rng.rand(B, n) > 0.2)
    valid[0] = False  # an env with no valid slot: every score ties
    pos = rng.randn(B, n, 3)
    return pos, depth, valid


@pytest.mark.parametrize("k", [1, 4, 7])
def test_topk_contacts_tie_order_matches_argsort(k):
    pos, depth, valid = _tie_case(18, 12)
    want = jax.jit(jax.vmap(lambda p, d, v: JX._topk_contacts(p, d, v, k)))(pos, depth, valid)
    got = X._topk_contacts(T(pos), T(depth), T(valid), k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("K", [1, 3, 6])
def test_select_contacts_tie_order_matches_top_k(K):
    """cube_drop (8 box-corner slots) with a budget of K: on contact sets
    with exact depth ties and invalid slots, the slots kept, their order,
    every field and the per-slot bodies equal lax.top_k's selection."""
    m = cube_drop(dtype=torch.float64, device="cpu").replace(contact_budget=K)
    jm = jax_model_of(m)
    pos, depth, valid = _tie_case(19 + K, 8)
    normal = np.random.RandomState(20).randn(B, 8, 3)
    fr, re = np.linspace(0.5, 0.9, 8), np.linspace(0.0, 0.3, 8)
    ba, bb = C.contact_slots(m)

    def jsel(pos, normal, depth, valid):
        c = JC.Contacts(pos, normal, depth, valid, jnp.asarray(fr), jnp.asarray(re))
        return JC.select_contacts(jm, c, jnp.asarray(ba), jnp.asarray(bb))

    (wc, wa, wb) = jax.jit(jax.vmap(jsel))(pos, normal, depth, valid)
    gc, ga, gb = C.select_contacts(m, C.Contacts(T(pos), T(normal), T(depth), T(valid), T(fr), T(re)))
    assert C.effective_contacts(m) == K and tuple(gc.depth.shape) == (B, K)
    for field in C.Contacts._fields:
        np.testing.assert_array_equal(getattr(gc, field).numpy(), np.asarray(getattr(wc, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
