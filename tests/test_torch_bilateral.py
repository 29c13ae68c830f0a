"""The joint types and constraint rows of the torch port's last vmap-stack
slice against the JAX package, float64 on the CPU, the same numpy inputs
on both sides:

* SCREW (pitch 0.05), UNIVERSAL, EULER, TRANSLATIONAL and TRANSLATIONAL2D,
  each as the root joint of a two-body model (a revolute child): forward
  kinematics and the mass matrix at every state of a 4-step trajectory,
  and each step re-synced to the JAX state, q atol 1e-10, v atol 1e-8
  (no contact: the same formulas, rounding only).
* A central-difference twin (h = 1e-6) of each type's motion subspace:
  S[k] = (vee(R^T dR/dq_k), R^T dp/dq_k) of joint_transform, on both
  sides, within 1e-8; and of motion_subspace_dot, the port's dS/dq . qdot
  written out, against differences of motion_subspace along qdot.
* Ball, weld and mimic rows: the assembled LCP (J, b, lo, hi, fidx) against
  JAX's prepare_constrained (atol 1e-12), and 4 re-synced steps, q atol
  1e-10 and v atol 1e-8 times max(1, max |v|) (the Woodbury polish
  amplifies rounding by about eps/cfm relative to the impulses, and the
  welded pair's velocities reach ~40: measured 8.9e-8 apart there), on a
  free body pinned to the world, a welded pair of free bodies and a double
  pendulum with a mimic row, near the poses where the constraints hold.
* Model data: the five builders of models/basic.py that the port gained,
  the chain of the five joint types and the models with bilateral rows,
  field for field against the JAX-built ones (model_to_numpy), carried
  across with model_from_numpy; Model.astype and quat_dof_mask.
* rollout_fast's _fallback_reason names the fused subset for these models.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.constraints.assembly import static_fidx as jax_static_fidx
from diffdart_tpu.dynamics import dynamics as JD
from diffdart_tpu.dynamics import joints as JJ
from diffdart_tpu.dynamics import model as JM
from diffdart_tpu.dynamics.kinematics import fk as jax_fk
from diffdart_tpu.models import basic as JB
from diffdart_tpu.sim import step as jax_step
from diffdart_tpu.sim.constrained import prepare_constrained as jax_prepare
from diffdart_tpu_torch.constraints.assembly import static_fidx
from diffdart_tpu_torch.dynamics import dynamics as D
from diffdart_tpu_torch.dynamics import joints as TJ
from diffdart_tpu_torch.dynamics import model as tm
from diffdart_tpu_torch.dynamics.kinematics import fk
from diffdart_tpu_torch.dynamics.model import JointType, ModelBuilder, State
from diffdart_tpu_torch.models import basic as TB
from diffdart_tpu_torch.sim import step as S
from diffdart_tpu_torch.sim.constrained import prepare_constrained
from diffdart_tpu_torch.sim.fast import _fallback_reason

from test_torch_model import _assert_same, _jax_fields
from test_torch_vmap_dynamics import T, close, jax_model_of

F64 = dict(dtype=torch.float64, device="cpu")
B, STEPS = 3, 4
J = JointType
NEW_TYPES = [J.SCREW, J.UNIVERSAL, J.EULER, J.TRANSLATIONAL, J.TRANSLATIONAL2D]
AXIS, AXIS2, PITCH = np.array([0.0, 0.6, 0.8]), np.array([1.0, 0.0, 0.0]), 0.05


def _inertia(mass, length=0.3, radius=0.02):
    return np.diag([0.5 * mass * radius**2] + [mass * (3 * radius**2 + length**2) / 12.0] * 2)


def _joint_model(jtype):
    """Root joint of `jtype` (axes AXIS, AXIS2, screw pitch PITCH) carrying
    a rod, and a revolute child rod."""
    b = ModelBuilder(dt=2e-3)
    root = b.add_body(parent=-1, jtype=jtype, axis=AXIS, axis2=AXIS2, screw_pitch=PITCH, mass=0.7,
                      com=(0.15, 0.05, 0.0), inertia=_inertia(0.7), damping=0.05)
    b.add_body(parent=root, jtype=J.REVOLUTE, axis=(0, 0, 1), X_pos=(0.3, 0, 0), mass=0.5,
               com=(0.15, 0, 0), inertia=_inertia(0.5))
    return b.finalize(**F64)


def _inputs(m, seed):
    rng = np.random.RandomState(seed)
    return 0.4 * rng.randn(B, m.nq), 0.5 * rng.randn(B, m.nv), 0.3 * rng.randn(B, m.nv)


def _jstate(q, v):
    return JM.State(q=q, v=v, t=jnp.zeros(()))


def _jax_trajectory(jm, q, v, tau, extra):
    """The JAX states of a STEPS-step trajectory from (q, v) and, at each,
    extra(q, v, tau), from one jitted program."""
    run = jax.jit(jax.vmap(lambda q, v, t: (jax_step(jm, _jstate(q, v), t), extra(q, v, t))))
    traj, outs = [(q, v)], []
    for _ in range(STEPS):
        s, out = run(*(jnp.asarray(x) for x in (*traj[-1], tau)))
        traj.append((np.asarray(s.q), np.asarray(s.v)))
        outs.append(out)
    return traj, outs


@pytest.mark.parametrize("jtype", NEW_TYPES)
def test_joint_type_matches_jax(jtype):
    m = _joint_model(jtype)
    jm = jax_model_of(m)
    q, v, tau = _inputs(m, seed=jtype)

    def extra(q, v, t):
        R, p = jax_fk(jm, q)
        return R, p, JD.mass_matrix(jm, q)

    traj, outs = _jax_trajectory(jm, q, v, tau, extra)
    for k in range(STEPS):
        qk, vk = T(traj[k][0]), T(traj[k][1])
        R, p = fk(m, qk)
        close(R, outs[k][0], msg=f"R at step {k}")
        close(p, outs[k][1], msg=f"p at step {k}")
        close(D.mass_matrix(m, qk), outs[k][2], rtol=1e-12, msg=f"M at step {k}")
        with torch.no_grad():
            s = S.step(m, State(q=qk, v=vk), T(tau))
        close(s.q, traj[k + 1][0], atol=1e-10, msg=f"q at step {k}")
        close(s.v, traj[k + 1][1], atol=1e-8, msg=f"v at step {k}")


def _vee(W):
    return np.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _fd_subspace(transform, q, h=1e-6):
    """(nv_j, 6) rows (vee(R^T dR/dq_k), R^T dp/dq_k) by central differences
    of transform(q) -> (R, p), for joints with nq = nv."""
    R, _ = (np.asarray(x) for x in transform(q))
    rows = []
    for k in range(q.shape[0]):
        e = np.zeros_like(q)
        e[k] = h
        (Rp, pp), (Rm, pm) = ([np.asarray(x) for x in transform(q + s * e)] for s in (1, -1))
        rows.append(np.r_[_vee(R.T @ (Rp - Rm) / (2 * h)), R.T @ (pp - pm) / (2 * h)])
    return np.stack(rows)


@pytest.mark.parametrize("jtype", NEW_TYPES)
def test_motion_subspace_is_the_derivative_of_the_transform(jtype):
    nq = J.DOF[jtype][0]
    q = np.random.RandomState(20 + jtype).randn(nq)
    qdot = np.random.RandomState(30 + jtype).randn(nq)
    ta, ta2, tp = T(AXIS), T(AXIS2), torch.tensor(PITCH, dtype=torch.float64)
    ja, ja2 = jnp.asarray(AXIS), jnp.asarray(AXIS2)

    def port(x):
        R, p = TJ.joint_transform(jtype, T(x)[None], ta, ta2, tp)
        return R[0].numpy(), p[0].numpy()

    def jax_(x):
        return JJ.joint_transform(jtype, jnp.asarray(x), ja, ja2, PITCH)

    S_port = TJ.motion_subspace(jtype, T(q)[None], ta, ta2, tp)[0].numpy()
    S_jax = np.asarray(JJ.motion_subspace(jtype, jnp.asarray(q), ja, ja2, PITCH))
    close(_fd_subspace(port, q), S_port, atol=1e-8, msg="port")
    close(_fd_subspace(jax_, q), S_jax, atol=1e-8, msg="JAX")
    close(S_port, S_jax, msg="port against JAX")
    # dS/dq . qdot against differences of S along qdot
    h = 1e-6
    Sp, Sm = (TJ.motion_subspace(jtype, T(q + s * h * qdot)[None], ta, ta2, tp)[0].numpy()
              for s in (1, -1))
    dS = TJ.motion_subspace_dot(jtype, T(q)[None], T(qdot)[None], ta, ta2)
    fd = (Sp - Sm) / (2 * h)
    if dS is None:
        assert np.abs(fd).max() < 1e-8
    else:
        close(dS[0], fd, atol=1e-8)


def _ball_pendulum(mod, **kw):
    """A free body pinned to the world at its origin (tests/test_bilateral.py)."""
    b = mod.ModelBuilder(dt=1e-3)
    b.add_body(parent=-1, jtype=J.FREE, mass=1.0, com=(0.3, 0, 0), inertia=np.eye(3) * 0.01)
    return mod.add_ball_constraint(b.finalize(**kw), -1, 0, world_point=(0.0, 0.0, 0.0))


def _welded_pair(mod, **kw):
    """Two free bodies 0.4 apart, welded (tests/test_bilateral.py)."""
    b = mod.ModelBuilder(dt=1e-3)
    for _ in range(2):
        b.add_body(parent=-1, jtype=J.FREE, mass=1.0, inertia=np.eye(3) * 0.01)
    m = b.finalize(**kw)
    q = np.array(m.neutral_q(), np.float64)
    q[11] = 0.4
    return mod.add_weld_constraint(m, 0, 1, q=q)


def _mimic_pendulum(mod, **kw):
    """A double pendulum whose second joint mimics the first: q1 = 0.5 q0 + 0.1."""
    m = (TB.double_pendulum if mod is tm else JB.double_pendulum)(dt=1e-3, **kw)
    return mod.add_mimic_constraint(m, 1, 0, multiplier=0.5, offset=0.1)


BILATERAL = {"ball_pendulum": _ball_pendulum, "welded_pair": _welded_pair, "mimic": _mimic_pendulum}


def _near_neutral(m, seed):
    """(q, v, tau) near the neutral pose, where the models' constraints hold:
    q off it by 1e-3 N(0, 1) (a drift of the size Baumgarte stabilisation
    keeps), v 0.5 N(0, 1), tau 0.2 N(0, 1)."""
    rng = np.random.RandomState(seed)
    q = np.tile(m.neutral_q().numpy(), (B, 1)) + 1e-3 * rng.randn(B, m.nq)
    return q, 0.5 * rng.randn(B, m.nv), 0.2 * rng.randn(B, m.nv)


@pytest.mark.parametrize("name", sorted(BILATERAL))
def test_bilateral_rows_match_jax(name):
    m = BILATERAL[name](tm, **F64).replace(lcp_pivot_iters=0)
    jm = jax_model_of(m)
    q, v, tau = _near_neutral(m, seed=len(name))
    assert static_fidx(m) == jax_static_fidx(jm)
    traj, outs = _jax_trajectory(jm, q, v, tau, lambda q, v, t: jax_prepare(jm, _jstate(q, v), t)[0])
    for k in range(STEPS):
        qk, vk = T(traj[k][0]), T(traj[k][1])
        with torch.no_grad():
            lcp = prepare_constrained(m, State(q=qk, v=vk), T(tau))[0]
            s = S.step(m, State(q=qk, v=vk), T(tau))
        want = outs[k]
        assert lcp.b.shape[-1] == len(static_fidx(m)) > 0
        for f in ("J", "b", "lo", "hi"):
            close(getattr(lcp, f), getattr(want, f), atol=1e-12, msg=f"{f} at step {k}")
        np.testing.assert_array_equal(lcp.fidx.numpy(), np.asarray(want.fidx)[0])
        close(s.q, traj[k + 1][0], atol=1e-10, msg=f"q at step {k}")
        v_scale = max(1.0, np.abs(traj[k + 1][1]).max())
        close(s.v, traj[k + 1][1], atol=1e-8 * v_scale, msg=f"v at step {k}")


NEW_MODELS = {
    "pendulum": (lambda: JB.pendulum(damping=0.1), lambda: TB.pendulum(damping=0.1, **F64)),
    "double_pendulum": (JB.double_pendulum, lambda: TB.double_pendulum(**F64)),
    "chain": (lambda: JB.chain(n=5, jtypes=NEW_TYPES), lambda: TB.chain(n=5, jtypes=NEW_TYPES, **F64)),
    "projectile": (JB.projectile, lambda: TB.projectile(**F64)),
    "capsule_lying": (JB.capsule_lying, lambda: TB.capsule_lying(**F64)),
    **{name: (lambda f=f: f(JM), lambda f=f: f(tm, **F64)) for name, f in BILATERAL.items()},
}


@pytest.mark.parametrize("name", sorted(NEW_MODELS))
def test_new_models_match_jax(name):
    jb, tb = NEW_MODELS[name]
    jm, m = jb(), tb()
    _assert_same(tm.model_to_numpy(m), _jax_fields(jm))
    carried = tm.model_from_numpy(_jax_fields(jm), device="cpu", dtype=torch.float64)
    _assert_same(tm.model_to_numpy(carried), tm.model_to_numpy(m))
    np.testing.assert_array_equal(m.quat_dof_mask, jm.quat_dof_mask)
    # astype: every floating tensor field cast, the rest untouched
    m32, jm32 = m.astype(torch.float32), jm.astype(jnp.float32)
    _assert_same(tm.model_to_numpy(m32), _jax_fields(jm32))
    for f in tm._ARRAY_FIELDS:
        x = getattr(m32, f)
        assert x is None or x.dtype == torch.float32, f
    assert m32.jtype == m.jtype and m32.contact_solver == m.contact_solver
    # outside the fused subset (joint types or bilateral rows) or inside it
    reason = _fallback_reason(m, torch.device("cpu"))
    outside = set(m.jtype) - {J.WELD, J.REVOLUTE, J.PRISMATIC, J.PLANAR, J.FREE, J.BALL} or \
        m.ball_pairs or m.weld_pairs or m.mimic_pairs
    assert (reason is not None and "fused subset" in reason) if outside else reason is None
