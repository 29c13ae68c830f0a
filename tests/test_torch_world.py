"""The port's World facade (diffdart_tpu_torch/sim/world.py) and recordings
(sim/recording.py) against the JAX package's, float64 on the CPU.

* The cases of tests/test_world.py, each run on a port World and a JAX
  World built alike: skeleton views, time, the mass matrix and bias forces
  (1e-12), control forces, and the falling ball (q 1e-9, v 1e-6 after 100
  steps, and the closed form within 1e-3).
* A World loaded from a .skel file steps as the JAX World loaded from it.
* A recording saved and loaded gives back the trajectory bit for bit;
  compare_to_golden holds every env of a batch.
* The three stored goldens (tests/goldens/*_f64.npz) through the port's
  rollout, B = 2 copies of each start, at tests/test_goldens.py's own
  tolerances and set-up: cartpole 1e-9, cube_drop q 1e-6 and v 1e-5,
  double_pendulum 1e-9.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.sim.world import World as JWorld
from diffdart_tpu_torch.dynamics.model import State
from diffdart_tpu_torch.math.lie import quat_normalize
from diffdart_tpu_torch.models import cartpole, cube_drop, double_pendulum
from diffdart_tpu_torch.sim.recording import compare_to_golden, load_recording, save_recording
from diffdart_tpu_torch.sim.step import rollout
from diffdart_tpu_torch.sim.world import World

from test_io import SKEL_PENDULUM
from test_world import _build_ball, _build_pendulum

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
F64 = torch.float64


def worlds(*builders, time_step=1e-3):
    """A port World (float64, CPU) and a JAX World with the same skeletons."""
    w, jw = World(time_step=time_step, dtype=F64, device="cpu"), JWorld(time_step=time_step)
    for b in builders:
        w.addSkeleton(b)
        jw.addSkeleton(b)
    return w, jw


def close(x, y, atol):
    np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol, rtol=0)


def test_skeleton_views():
    w, jw = worlds()
    pend = w.addSkeleton(_build_pendulum, name="pendulum")
    ball = w.addSkeleton(_build_ball, name="ball")
    jpend = jw.addSkeleton(_build_pendulum, name="pendulum")
    jw.addSkeleton(_build_ball, name="ball")
    assert w.getNumSkeletons() == jw.getNumSkeletons() == 2
    assert (pend.getNumDofs(), ball.getNumDofs()) == (1, 6)
    assert pend.getNumBodyNodes() == 1 and ball.getName() == "ball"
    pend.setPositions([0.3])
    jpend.setPositions(jnp.array([0.3]))
    close(pend.getPositions(), jpend.getPositions(), 0)
    close(w.getPositions(), jw.getPositions(), 0)
    assert w.getSkeleton("ball") is ball and w.getSkeleton(0) is pend
    assert w.getState().q.shape == (1, 8) and w.getPositions().shape == (8,)


def test_step_advances_time():
    w, jw = worlds(_build_pendulum, time_step=2e-3)
    for _ in range(5):
        w.step()
        jw.step()
    close(w.getTime(), 0.01, 1e-12)
    close(w.getTime(), jw.getTime(), 1e-15)
    w.setTimeStep(1e-3)
    jw.setTimeStep(1e-3)
    w.step()
    jw.step()
    assert w.getTimeStep() == jw.getTimeStep() == 1e-3
    close(w.getPositions(), jw.getPositions(), 1e-12)


def test_mass_matrix_and_forces():
    w, jw = worlds(_build_pendulum)
    for world in (w, jw):
        world.getSkeleton(0).setPositions([0.5])
        world.getSkeleton(0).setVelocities([0.7])
    pend, jpend = w.getSkeleton(0), jw.getSkeleton(0)
    M = pend.getMassMatrix()
    assert M.shape == (1, 1)
    close(M, jpend.getMassMatrix(), 1e-12)
    close(float(M[0, 0]), 0.02 + 1.0 * 0.25, 1e-12)
    close(pend.getCoriolisAndGravityForces(), jpend.getCoriolisAndGravityForces(), 1e-12)
    close(pend.computeForwardDynamics(), jpend.computeForwardDynamics(), 1e-12)
    close(pend.getCOM(), jpend.getCOM(), 1e-12)


def test_control_forces():
    w, jw = worlds(_build_pendulum)
    for world, arr in ((w, torch.tensor([2.0])), (jw, jnp.array([2.0]))):
        pend = world.getSkeleton(0)
        pend.setControlForces(arr)
        world.step(reset_command=False)
        close(pend.getControlForces(), [2.0], 0)
        world.step()  # resetCommand clears
        close(pend.getControlForces(), [0.0], 0)
    close(w.getVelocities(), jw.getVelocities(), 1e-12)


def test_gravity_projectile_through_world():
    w, jw = worlds(_build_ball)
    q = np.zeros(7)
    q[0], q[6] = 1.0, 1.0  # z = 1
    w.getSkeleton(0).setPositions(torch.tensor(q))
    jw.getSkeleton(0).setPositions(jnp.asarray(q))
    for _ in range(100):
        w.step()
        jw.step()
    z = float(w.getSkeleton(0).getPositions()[6])
    close(z, 1.0 - 0.5 * 9.81 * 0.1**2, 1e-3)
    close(w.getPositions(), jw.getPositions(), 1e-9)
    close(w.getVelocities(), jw.getVelocities(), 1e-6)


def test_load_skeleton_from_a_scene_file(tmp_path):
    """World.loadSkeleton (io.load_into_builder) on a .skel file: the same
    Model and the same 20 steps as the JAX World's."""
    path = tmp_path / "pend.skel"
    path.write_text(SKEL_PENDULUM)
    w = World(time_step=2e-3, dtype=F64, device="cpu")
    jw = JWorld(time_step=2e-3)
    sk = w.loadSkeleton(str(path), name="pend")
    jw.loadSkeleton(str(path), name="pend")
    assert sk.getNumDofs() == 1 and w.getSkeleton("pend") is sk
    for _ in range(20):
        w.step()
        jw.step()
    close(w.getPositions(), jw.getPositions(), 1e-9)
    close(w.getVelocities(), jw.getVelocities(), 1e-6)
    assert abs(float(w.getVelocities()[0])) > 0


def test_recording_round_trip(tmp_path):
    m = double_pendulum(dt=2e-3, dtype=F64, device="cpu")
    s = State(q=torch.tensor([[1.2, -0.5], [0.3, 0.1]], dtype=F64), v=torch.zeros(2, 2, dtype=F64),
              t=torch.zeros(2, dtype=F64))
    with torch.no_grad():
        _, traj = rollout(m, s, torch.zeros(30, 2, 2, dtype=F64))
    path = save_recording(str(tmp_path / "rec.npz"), traj, meta={"note": "two envs"})
    back = load_recording(path, device="cpu")
    for a, b in ((traj.q, back.q), (traj.v, back.v), (traj.t, back.t)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert str(np.load(path)["meta_note"]) == "two envs"
    assert load_recording(path, device="cpu", dtype=torch.float32).q.dtype == torch.float32
    # a golden of env 0: env 0 holds to it, env 1 does not
    np.savez(tmp_path / "g.npz", q=traj.q[:, 0].numpy(), v=traj.v[:, 0].numpy())
    r = compare_to_golden(traj, str(tmp_path / "g.npz"), q_tol=1e-12, v_tol=1e-12)
    assert r["env_dq"][0] == 0 and r["env_dq"][1] > 0.1 and not r["q_ok"]
    one = State(q=traj.q[:, 0], v=traj.v[:, 0])
    assert compare_to_golden(one, str(tmp_path / "g.npz"), q_tol=0, v_tol=0)["q_ok"]


def golden_case(name, B=2, dtype=F64, device="cpu"):
    """(model, start State of B copies, taus (T, B, nv)) of
    tests/test_goldens.py's set-up for one golden."""
    kw = dict(dtype=dtype, device=device)
    if name == "cartpole":
        m = cartpole(dt=5e-3, **kw)
        q, v = torch.tensor([0.1, 0.4], **kw), torch.tensor([-0.2, 0.3], **kw)
        taus = 0.5 * torch.sin(torch.arange(200.0, **kw))[:, None] * torch.tensor([[1.0, 0.0]], **kw)
    elif name == "cube_drop":
        m = cube_drop(dt=2e-3, half=0.1, friction=0.5, restitution=0.3, **kw)
        q = m.neutral_q().clone()
        q[6], q[1], q[0] = 0.3, 0.1, 0.99499
        q[:4] = quat_normalize(q[:4])
        v = torch.zeros(6, **kw)
        v[3] = 1.0
        taus = torch.zeros(400, 6, **kw)
    else:
        m = double_pendulum(dt=2e-3, **kw)
        q, v = torch.tensor([1.2, -0.5], **kw), torch.zeros(2, **kw)
        taus = torch.zeros(500, 2, **kw)
    s = State(q=q.repeat(B, 1), v=v.repeat(B, 1), t=torch.zeros(B, **kw))
    return m, s, taus[:, None].expand(-1, B, -1).contiguous()


# golden -> (q tolerance, v tolerance), tests/test_goldens.py's
GOLDEN_TOLS = {"cartpole": (1e-9, 1e-9), "cube_drop": (1e-6, 1e-5), "double_pendulum": (1e-9, 1e-9)}


@pytest.mark.parametrize("name", sorted(GOLDEN_TOLS))
def test_goldens(name):
    m, s, taus = golden_case(name)
    with torch.no_grad():
        _, traj = rollout(m, s, taus)
    q_tol, v_tol = GOLDEN_TOLS[name]
    r = compare_to_golden(traj, os.path.join(GOLDENS, f"{name}_f64.npz"), q_tol=q_tol, v_tol=v_tol)
    assert r["q_ok"] and r["v_ok"], r
