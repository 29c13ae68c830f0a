"""The torch port's vmap-stack algebra against the JAX package, float64 on
the CPU: math/lie.py, math/spatial.py, ops/smalllinalg.py,
dynamics/joints.py, and dynamics/kinematics.py + dynamics/dynamics.py
(kinematics cache, mass matrix, bias forces, implicit joint terms,
integrate_positions, position_difference) on every test model, each
against jax.vmap of its JAX counterpart. Also models/basic.py against the
JAX builders.

The port's functions are batch-first (B, ...); the same numpy inputs go to
both packages. Tolerances: 1e-12 absolute (relative for the mass matrix
and bias forces, whose entries reach ~1e2): both packages run the same
formulas, and only summation order differs (torch.einsum and XLA:CPU's
dot reassociate differently); the dynamics terms are rounding-level
(~1e-14) apart.

Shared with the other test_torch_vmap/collision/lcp files: MODELS (name ->
port model and its q0) and jax_model_of (the JAX Model with the port
model's fields).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.dynamics import dynamics as JD
from diffdart_tpu.dynamics import joints as JJ
from diffdart_tpu.dynamics.model import Model as JModel
from diffdart_tpu.math import lie as JL
from diffdart_tpu.math import spatial as JS
from diffdart_tpu.models import cartpole as jax_cartpole
from diffdart_tpu.models import cube_drop as jax_cube_drop
from diffdart_tpu.ops import smalllinalg as JSL
from diffdart_tpu_torch.dynamics import dynamics as D
from diffdart_tpu_torch.dynamics import joints as TJ
from diffdart_tpu_torch.dynamics.model import JointType, ModelBuilder, model_to_numpy
from diffdart_tpu_torch.math import lie as L
from diffdart_tpu_torch.math import spatial as S
from diffdart_tpu_torch.models import cartpole, cheetah_init_q, cube_drop, half_cheetah
from diffdart_tpu_torch.ops import smalllinalg as SL

from test_torch_cuda import KERNEL_MODELS
from test_torch_cuda import inputs as _inputs

F64 = dict(dtype=torch.float64, device="cpu")
B = 8


def _cheetah_low(dtype, device):
    """Half-cheetah with the root lowered 0.25 so that feet and shins touch
    the floor."""
    m = half_cheetah(dt=2e-3, dtype=dtype, device=device)
    return m, cheetah_init_q(m).cpu().numpy() - np.r_[0.25, np.zeros(m.nq - 1)]


def _cube(dtype, device):
    m = cube_drop(dt=2e-3, dtype=dtype, device=device)
    q0 = m.neutral_q().cpu().numpy()
    q0[6] = 0.1
    return m, q0


def _cartpole(dtype, device):
    return cartpole(dt=0.01, dtype=dtype, device=device), np.array([0.0, 3.0])


# name -> builder(dtype, device) -> (port model, q0 as numpy)
MODELS = dict(KERNEL_MODELS, half_cheetah=_cheetah_low, cube_drop=_cube, cartpole=_cartpole)


def jax_model_of(m) -> JModel:
    """The JAX-package Model with every field of port model m."""
    kw = {}
    for name, x in model_to_numpy(m).items():
        kw[name] = jnp.asarray(x) if isinstance(x, np.ndarray) else x
    return JModel(**kw)


def batch(name, B=B, seed=0):
    """(port model float64 on the CPU, JAX model, q, v, tau numpy (B, k))."""
    m, q0 = MODELS[name](torch.float64, "cpu")
    return (m, jax_model_of(m), *_inputs(q0, m.nq, m.nv, B, seed))


def T(x):
    return torch.tensor(np.asarray(x))


def close(got, want, atol=1e-12, rtol=0.0, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


# ---------------------------------------------------------------------------
# math


def _rng_vec(shape, seed, scale=1.0):
    return scale * np.random.RandomState(seed).randn(*shape)


def _rot(seed):
    return np.asarray(JL.exp_so3(jnp.asarray(_rng_vec((B, 3), seed, 1.5))))


LIE_CASES = {
    "exp_so3": (lambda m, x: m.exp_so3(x), lambda: [_rng_vec((B, 3), 1) * np.r_[1, 1, 1, 1, 1e-5, 0, 1, 1][:, None]]),
    "log_so3": (lambda m, x: m.log_so3(x), lambda: [_rot(2)]),
    "exp_se3": (lambda m, x: m.exp_se3(x), lambda: [_rng_vec((B, 6), 3)]),
    "log_se3": (lambda m, R, p: m.log_se3(R, p), lambda: [_rot(4), _rng_vec((B, 3), 5)]),
    "quat_mul": (lambda m, a, b: m.quat_mul(a, b), lambda: [_rng_vec((B, 4), 6), _rng_vec((B, 4), 7)]),
    "quat_rotate": (lambda m, q, v: m.quat_rotate(q, v), lambda: [_rng_vec((B, 4), 8), _rng_vec((B, 3), 9)]),
    "quat_to_mat": (lambda m, q: m.quat_to_mat(m.quat_normalize(q)), lambda: [_rng_vec((B, 4), 10)]),
    "mat_to_quat": (lambda m, R: m.mat_to_quat(R), lambda: [_rot(11)]),
    "quat_exp": (lambda m, v: m.quat_exp(v), lambda: [_rng_vec((B, 3), 12) * np.r_[1, 1, 1, 0, 1, 1, 1e-6, 1][:, None]]),
    "quat_log": (lambda m, q: m.quat_log(m.quat_normalize(q)), lambda: [_rng_vec((B, 4), 13)]),
    "tf_compose": (lambda m, R, p, R2, p2: m.tf_compose(R, p, R2, p2),
                   lambda: [_rot(14), _rng_vec((B, 3), 15), _rot(16), _rng_vec((B, 3), 17)]),
    "tf_inverse": (lambda m, R, p: m.tf_inverse(R, p), lambda: [_rot(18), _rng_vec((B, 3), 19)]),
}


@pytest.fixture(scope="module")
def lie_ref():
    """Every LIE_CASES input and its JAX result, from one jitted program."""
    xs = {name: args() for name, (fn, args) in LIE_CASES.items()}
    run = jax.jit(lambda xs: {n: jax.tree_util.tree_leaves(LIE_CASES[n][0](JL, *a)) for n, a in xs.items()})
    return xs, run(jax.tree_util.tree_map(jnp.asarray, xs))


@pytest.mark.parametrize("name", sorted(LIE_CASES))
def test_lie_matches_jax(name, lie_ref):
    xs, want = lie_ref[0][name], lie_ref[1][name]
    got = LIE_CASES[name][0](L, *(T(x) for x in xs))
    got = list(got) if isinstance(got, tuple) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w, msg=name)


SPATIAL_CASES = {
    "motion_cross": lambda m, R, p, a, b: m.motion_cross(a, b),
    "force_cross": lambda m, R, p, a, b: m.force_cross(a, b),
    "transform_motion": lambda m, R, p, a, b: m.transform_motion(R, p, a),
    "inv_transform_motion": lambda m, R, p, a, b: m.inv_transform_motion(R, p, a),
    "transform_force": lambda m, R, p, a, b: m.transform_force(R, p, a),
    "X_motion": lambda m, R, p, a, b: m.X_motion(R, p),
    "transform_inertia": lambda m, R, p, a, b: m.transform_inertia(
        R, p, m.spatial_inertia(a[..., 0] ** 2, b[..., :3], R @ R.swapaxes(-1, -2) * 0.3)),
}


def _spatial_inputs():
    return [_rot(20), _rng_vec((B, 3), 21), _rng_vec((B, 6), 22), _rng_vec((B, 6), 23)]


@pytest.fixture(scope="module")
def spatial_ref():
    run = jax.jit(lambda *a: {n: fn(JS, *a) for n, fn in SPATIAL_CASES.items()})
    return run(*(jnp.asarray(x) for x in _spatial_inputs()))


@pytest.mark.parametrize("name", sorted(SPATIAL_CASES))
def test_spatial_matches_jax(name, spatial_ref):
    close(SPATIAL_CASES[name](S, *(T(x) for x in _spatial_inputs())), spatial_ref[name], msg=name)


# ---------------------------------------------------------------------------
# small linear algebra


def _spd(n, seed, dtype=np.float64):
    X = np.random.RandomState(seed).randn(B, n, n)
    return (X @ X.transpose(0, 2, 1) + n * np.eye(n)).astype(dtype)


@pytest.mark.parametrize("n", [1, 4, 9])
def test_cholesky_and_solves_match_jax(n):
    A = _spd(n, n)
    rhs = np.random.RandomState(30 + n).randn(B, n)
    rhs_m = np.random.RandomState(40 + n).randn(B, n, 3)
    def ref(A, r, rm):
        L_ = jax.vmap(JSL.cholesky_small)(A)
        return (L_, jax.vmap(JSL.cho_solve_small)(L_, r), jax.vmap(JSL.cho_solve_small)(L_, rm),
                jax.vmap(JSL.inv_small_spd)(A))

    Lj, xj, xmj, invj = jax.jit(ref)(jnp.asarray(A), jnp.asarray(rhs), jnp.asarray(rhs_m))
    Lt = SL.cholesky_small(T(A))
    close(Lt, Lj)
    close(SL.cho_solve_small(Lt, T(rhs)), xj)
    close(SL.cho_solve_small(Lt, T(rhs_m)), xmj)
    close(SL.spd_solve_small(T(A), T(rhs)), np.linalg.solve(A, rhs[..., None])[..., 0], atol=1e-12)
    close(SL.inv_small_spd(T(A)), invj)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solve_nopivot_matches_jax(dtype):
    """float64 runs the plain elimination, float32 the dead-pivot guard;
    the guarded float32 path agrees with JAX to float32 rounding (1e-5 on
    O(1) solutions)."""
    n = 9
    A = _spd(n, 50, dtype) + np.triu(np.ones((n, n)), 1).astype(dtype)  # not symmetric
    rhs = np.random.RandomState(51).randn(B, n).astype(dtype)
    rhs_m = np.random.RandomState(52).randn(B, n, 2).astype(dtype)
    atol = 1e-12 if dtype == np.float64 else 1e-5
    ref = jax.jit(lambda A, r, rm: (jax.vmap(JSL.solve_nopivot_small)(A, r),
                                    jax.vmap(JSL.solve_nopivot_small)(A, rm)))
    for r, want in zip((rhs, rhs_m), ref(jnp.asarray(A), jnp.asarray(rhs), jnp.asarray(rhs_m))):
        close(SL.solve_nopivot_small(T(A), T(r)), want, atol=atol)
    # singular system in float32: finite garbage, never inf or NaN
    Z = np.zeros((B, n, n), np.float32)
    out = SL.solve_nopivot_small(T(Z), T(rhs.astype(np.float32)))
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# joints


JOINTS = {
    JointType.REVOLUTE: 1, JointType.PRISMATIC: 1, JointType.PLANAR: 3, JointType.WELD: 0,
    JointType.FREE: 7, JointType.BALL: 4,
}


_AXES = np.array([0.0, 0.6, 0.8]), np.array([1.0, 0.0, 0.0])


def _joint_inputs(jtype):
    nq = JOINTS[jtype]
    nv = {JointType.FREE: 6, JointType.BALL: 3}.get(jtype, nq)
    q = _rng_vec((B, nq), 60 + jtype)
    if jtype in (JointType.FREE, JointType.BALL):
        q[:, :4] += np.r_[2.0, 0, 0, 0]
    return q, q + 0.1 * _rng_vec((B, nq), 70 + jtype), _rng_vec((B, nv), 80 + jtype)


@pytest.fixture(scope="module")
def joint_ref():
    """jtype -> JAX (R, p, S, integrated, difference, dS/dq . v) from one
    jitted program; dS by jax.jvp of motion_subspace, as the JAX package's
    kinematics takes it."""
    ja, ja2, jp = jnp.asarray(_AXES[0]), jnp.asarray(_AXES[1]), jnp.asarray(0.0)

    def one(jtype, q, q2, vj):
        R, p = JJ.joint_transform(jtype, q, ja, ja2, jp)
        Sq, dS = jax.jvp(lambda y: JJ.motion_subspace(jtype, y, ja, ja2, jp), (q,), (vj[:q.shape[0]],)) \
            if q.shape[0] == vj.shape[0] else (JJ.motion_subspace(jtype, q, ja, ja2, jp), None)
        return (R, p, Sq, JJ.integrate_joint(jtype, q, vj, 0.01), JJ.joint_difference(jtype, q, q2), dS)

    run = jax.jit(lambda xs: {j: jax.vmap(lambda *a, j=j: one(j, *a))(*x) for j, x in xs.items()})
    return run({j: tuple(jnp.asarray(x) for x in _joint_inputs(j)) for j in JOINTS})


@pytest.mark.parametrize("jtype", sorted(JOINTS))
def test_joint_maps_match_jax(jtype, joint_ref):
    q, q2, vj = (T(x) for x in _joint_inputs(jtype))
    ta, ta2 = T(_AXES[0]), T(_AXES[1])
    R, p, Sq, qi, dq, dS = joint_ref[jtype]
    Rt, pt = TJ.joint_transform(jtype, q, ta, ta2)
    close(Rt, R)
    close(pt, p)
    close(TJ.motion_subspace(jtype, q, ta, ta2), Sq)
    close(TJ.integrate_joint(jtype, q, vj, 0.01), qi)
    close(TJ.joint_difference(jtype, q, q2), dq)
    dSt = TJ.motion_subspace_dot(jtype, q, vj, ta, ta2)
    if jtype == JointType.PLANAR:
        close(dSt, dS)
    else:  # S does not depend on q
        assert dSt is None and (dS is None or not np.asarray(dS).any())


def test_unported_joint_types_raise():
    """Every joint type of the JAX package is ported (tests/
    test_torch_bilateral.py holds the five of the last slice against it);
    an id that is no joint type raises."""
    b = ModelBuilder(dt=1e-3)
    b.add_body(parent=-1, jtype=JointType.UNIVERSAL)
    m = b.finalize(**F64)
    R = D.kinematics_cache(m, torch.zeros(2, 2, dtype=torch.float64), torch.zeros(2, 2, dtype=torch.float64))["R"]
    assert R.shape == (2, 1, 3, 3)
    q, ax = torch.zeros(2, 1, dtype=torch.float64), T(_AXES[0])
    for fn in (TJ.joint_transform, TJ.motion_subspace):
        with pytest.raises(ValueError, match="unknown joint type"):
            fn(11, q, ax, ax)


# ---------------------------------------------------------------------------
# kinematics and dynamics, per model


@pytest.fixture(scope="module")
def dyn_ref():
    """name -> JAX results of jit(vmap(...)) at batch(name), computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            m, jm, q, v, tau = batch(name)

            def one(q, v):
                c = JD.kinematics_cache(jm, q, v)
                M = JD.mass_matrix(jm, q, c)
                C = JD.bias_forces(jm, q, v, c)
                extra, f = JD.implicit_joint_terms(jm, q, v, jm.dt)
                qi = JD.integrate_positions(jm, q, v, jm.dt)
                return dict(c, M=M, C=C, extra=jnp.broadcast_to(extra, v.shape), f=f, qi=qi,
                            dq=JD.position_difference(jm, q, qi), qt=JD.q_tangent(jm, q))

            cache[name] = (m, q, v, jax.jit(jax.vmap(one))(jnp.asarray(q), jnp.asarray(v)))
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(MODELS))
def test_kinematics_cache_matches_jax(name, dyn_ref):
    m, q, v, want = dyn_ref(name)
    got = D.kinematics_cache(m, T(q), T(v))
    for key in ("R", "p", "Sw", "V", "I_w"):
        close(got[key], want[key], atol=1e-12, msg=key)
    close(got["mask"], want["mask"][0])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_dynamics_terms_match_jax(name, dyn_ref):
    m, q, v, want = dyn_ref(name)
    qt, vt = T(q), T(v)
    c = D.kinematics_cache(m, qt, vt)
    close(D.mass_matrix(m, qt, c), want["M"], atol=1e-12, rtol=1e-13, msg="M")
    close(D.bias_forces(m, qt, vt, c), want["C"], atol=1e-11, rtol=1e-13, msg="C")
    extra, f = D.implicit_joint_terms(m, qt, vt, m.dt)
    close(extra.expand_as(vt), want["extra"], msg="extra diag")
    close(f, want["f"], msg="f")
    qi = D.integrate_positions(m, qt, vt, m.dt)
    close(qi, want["qi"], msg="integrate_positions")
    close(D.position_difference(m, qt, qi), want["dq"], msg="position_difference")
    close(D.q_tangent(m, qt), want["qt"], msg="q_tangent")


@pytest.mark.parametrize("which", ["cartpole", "cube_drop"])
def test_basic_models_match_jax(which):
    from test_torch_model import _assert_same, _jax_fields

    if which == "cartpole":
        _assert_same(model_to_numpy(cartpole(dt=0.01, **F64)), _jax_fields(jax_cartpole(dt=0.01)))
    else:
        _assert_same(model_to_numpy(cube_drop(dt=2e-3, **F64)), _jax_fields(jax_cube_drop(dt=2e-3)))


def test_jax_model_of_keeps_every_field():
    m, _ = MODELS["servo_cheetah"](torch.float64, "cpu")
    jm = jax_model_of(m)
    assert {f.name for f in dataclasses.fields(jm)} == set(model_to_numpy(m))
    assert jm.servo_dofs == m.servo_dofs and jm.contact_solver == m.contact_solver
