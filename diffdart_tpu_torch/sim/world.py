"""DART-style World and Skeleton facade over the batch-first core.
Counterpart of diffdart_tpu/sim/world.py, with DART's camelCase method
names as the JAX package has them (World::step / setTimeStep /
getNumSkeletons, Skeleton::setPositions / getPositions / getMassMatrix /
getCoriolisAndGravityForces / computeForwardDynamics / getCOM, ...).

A World owns one Model (every skeleton merged into it) and the current
State of one env: q (1, nq), v (1, nv), t (1,), on `device` (default the
card). step() runs sim/step.py::step on it, with no compilation step;
Skeleton objects are dof-range views into the World. Getters return the
env's own (nq,) / (nv,) / (k, k) tensors; setters take those shapes.

The facade is a thin layer for scene set-up and inspection: batched
simulation and training use sim/step.py, sim/fast.py and the kernels
directly.
"""
from __future__ import annotations

import torch

from diffdart_tpu_torch.dynamics import dynamics as D
from diffdart_tpu_torch.dynamics import kinematics as K
from diffdart_tpu_torch.dynamics.model import JointType, Model, ModelBuilder, State, make_state
from diffdart_tpu_torch.sim.step import step as _step_fn


class Skeleton:
    """A dof and body range of its World's model."""

    def __init__(self, world: "World", name: str, body_range, q_range, v_range):
        self._world = world
        self._name = name
        self._bodies = body_range  # (start, stop) body indices
        self._q = q_range
        self._v = v_range

    # -- identity ----------------------------------------------------------
    def getName(self) -> str:
        return self._name

    def getNumBodyNodes(self) -> int:
        return self._bodies[1] - self._bodies[0]

    def getNumDofs(self) -> int:
        return self._v[1] - self._v[0]

    # -- state -------------------------------------------------------------
    def getPositions(self):
        return self._world.getState().q[0, self._q[0]:self._q[1]]

    def setPositions(self, q):
        w = self._world
        s = w.getState()
        qn = s.q.clone()
        qn[0, self._q[0]:self._q[1]] = torch.as_tensor(q, dtype=s.q.dtype, device=s.q.device)
        w.state = State(q=qn, v=s.v, t=s.t)

    def getVelocities(self):
        return self._world.getState().v[0, self._v[0]:self._v[1]]

    def setVelocities(self, v):
        w = self._world
        s = w.getState()
        vn = s.v.clone()
        vn[0, self._v[0]:self._v[1]] = torch.as_tensor(v, dtype=s.v.dtype, device=s.v.device)
        w.state = State(q=s.q, v=vn, t=s.t)

    def getControlForces(self):
        self._world._finalize()
        return self._world._tau[0, self._v[0]:self._v[1]]

    def setControlForces(self, tau):
        w = self._world
        w._finalize()
        tn = w._tau.clone()
        tn[0, self._v[0]:self._v[1]] = torch.as_tensor(tau, dtype=tn.dtype, device=tn.device)
        w._tau = tn

    # -- dynamics queries ---------------------------------------------------
    def getMassMatrix(self):
        m, s = self._world.model, self._world.state
        M = D.mass_matrix(m, s.q)[0]
        return M[self._v[0]:self._v[1], self._v[0]:self._v[1]]

    def getCoriolisAndGravityForces(self):
        m, s = self._world.model, self._world.state
        return D.bias_forces(m, s.q, s.v)[0, self._v[0]:self._v[1]]

    def computeForwardDynamics(self):
        m, s = self._world.model, self._world.state
        return D.forward_dynamics(m, s.q, s.v, self._world._tau)[0, self._v[0]:self._v[1]]

    def getCOM(self):
        """(3,) world centre of mass of this skeleton's bodies."""
        m, s = self._world.model, self._world.state
        R, p = K.fk(m, s.q)
        b0, b1 = self._bodies
        mass = m.mass[b0:b1]
        coms = K.com_positions(m, R, p)[0, b0:b1]
        return torch.einsum("b,bi->i", mass, coms) / torch.sum(mass)


class World:
    """A scene of skeletons, built with builder functions or loaded from
    files, then stepped: the first step (or state access) finalizes the
    merged Model on `device` in `dtype`."""

    def __init__(self, gravity=(0, 0, -9.81), time_step=1e-3, dtype=torch.float32, device="cuda"):
        self._builder = ModelBuilder(gravity=gravity, dt=time_step)
        self._dtype, self._device = dtype, device
        self._skeletons: list[Skeleton] = []
        self._model: Model | None = None
        self.state: State | None = None
        self._tau = None

    # -- scene construction -------------------------------------------------
    def addSkeleton(self, build_fn, name: str | None = None) -> Skeleton:
        """build_fn(builder) adds the bodies and geoms of one skeleton and
        returns nothing; the range it added becomes the Skeleton view."""
        if self._model is not None:
            raise RuntimeError("cannot add skeletons after the world is finalized")
        b = self._builder
        b0, q0, v0 = len(b.bodies), _total_nq(b), _total_nv(b)
        build_fn(b)
        name = name or f"skeleton{len(self._skeletons)}"
        sk = Skeleton(self, name, (b0, len(b.bodies)), (q0, _total_nq(b)), (v0, _total_nv(b)))
        self._skeletons.append(sk)
        return sk

    def loadSkeleton(self, path: str, name: str | None = None, **kw) -> Skeleton:
        """Load a scene file (URDF, SKEL, SDF, VSK, MJCF; io.load_into_builder)
        as a new skeleton."""
        from diffdart_tpu_torch.io import load_into_builder

        return self.addSkeleton(lambda b: load_into_builder(b, path, **kw), name=name)

    # -- finalize / access ---------------------------------------------------
    def _finalize(self):
        if self._model is None:
            self._model = self._builder.finalize(dtype=self._dtype, device=self._device)
            s = make_state(self._model)
            self.state = State(q=s.q[None], v=s.v[None], t=s.t[None])
            self._tau = torch.zeros_like(self.state.v)

    @property
    def model(self) -> Model:
        self._finalize()
        return self._model

    def getNumSkeletons(self) -> int:
        return len(self._skeletons)

    def getSkeleton(self, i) -> Skeleton:
        if isinstance(i, str):
            return next(s for s in self._skeletons if s.getName() == i)
        return self._skeletons[i]

    # -- sim loop ------------------------------------------------------------
    def setTimeStep(self, dt: float):
        if self._model is None:
            self._builder.dt = dt
        else:
            self._model = self._model.replace(dt=torch.as_tensor(dt, dtype=self._model.dt.dtype,
                                                                 device=self._model.dt.device))

    def getTimeStep(self) -> float:
        return float(self._builder.dt if self._model is None else self._model.dt)

    def getTime(self) -> float:
        return float(self.state.t[0]) if self.state is not None else 0.0

    def step(self, reset_command: bool = True):
        """One timestep; reset_command clears the control forces afterwards
        (World::step's resetCommand)."""
        self._finalize()
        self.state = _step_fn(self._model, self.state, self._tau)
        if reset_command:
            self._tau = torch.zeros_like(self._tau)

    def getState(self) -> State:
        """The batched State of the world's one env: q (1, nq), v (1, nv), t (1,)."""
        self._finalize()
        return self.state

    def setState(self, state: State):
        self._finalize()
        self.state = state

    def getPositions(self):
        return self.getState().q[0]

    def setPositions(self, q):
        s = self.getState()
        self.state = State(q=torch.as_tensor(q, dtype=s.q.dtype, device=s.q.device).reshape(1, -1),
                           v=s.v, t=s.t)

    def getVelocities(self):
        return self.getState().v[0]

    def setVelocities(self, v):
        s = self.getState()
        self.state = State(q=s.q, v=torch.as_tensor(v, dtype=s.v.dtype, device=s.v.device).reshape(1, -1),
                           t=s.t)


def _total_nq(builder: ModelBuilder) -> int:
    return sum(JointType.DOF[b.jtype][0] for b in builder.bodies)


def _total_nv(builder: ModelBuilder) -> int:
    return sum(JointType.DOF[b.jtype][1] for b in builder.bodies)
