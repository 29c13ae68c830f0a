"""Coordinate mappings: optimize and backpropagate in other coordinates,
such as task space. Counterpart of diffdart_tpu/neural/mappings.py,
batch-first: q (B, nq), task positions (B, 3 k).

A Mapping is a (map, unmap) pair; IKMapping maps q to the world positions
of chosen bodies and inverts by damped-least-squares Gauss-Newton on the
batched FK; HierarchicalIK stacks prioritized levels of point tasks with
nullspace projection. The task Jacobian is taken in tangent coordinates,
d/d(dq) of the task at q (+) dq, dq = 0, by forward mode (torch.func.jvp
over one copy of each env per dof): the JAX package's jax.jacfwd.
"""
from __future__ import annotations

import torch

from diffdart_tpu_torch.dynamics import dynamics as D
from diffdart_tpu_torch.dynamics import kinematics as K
from diffdart_tpu_torch.dynamics.model import Model
from diffdart_tpu_torch.math.lie import tf_apply


def _tangent_jacobian(model: Model, q, task):
    """(B, m, nv): d task(q (+) dq) / d dq at dq = 0. One forward-mode pass
    (torch.func.jvp) over nv copies of each env, copy k along dof k: the
    task is separate per env, so copy k's tangent is column k."""
    nv = model.nv
    lead = q.shape[:-1]
    qr = q.unsqueeze(-2).expand(*lead, nv, q.shape[-1])
    eye = torch.eye(nv, dtype=q.dtype, device=q.device).expand(*lead, nv, nv)

    def f(dq):
        return task(D.integrate_positions(model, qr, dq, 1.0))

    cols = torch.func.jvp(f, (torch.zeros_like(eye),), (eye,))[1]  # (..., nv, m)
    return cols.transpose(-1, -2)


def _dls_step(J, err, damping):
    """J^T (J J^T + damping I)^-1 err per env."""
    H = J @ J.transpose(-1, -2) + damping * torch.eye(J.shape[-2], dtype=J.dtype, device=J.device)
    return (J.transpose(-1, -2) @ torch.linalg.solve(H, err.unsqueeze(-1))).squeeze(-1)


class IdentityMapping:
    """The trivial mapping."""

    def __init__(self, model: Model):
        self.model = model

    def map_pos(self, q):
        return q

    def unmap_pos(self, z, q_guess=None):
        return z


def solve_ik(model: Model, body: int, target_pos, q0, iters: int = 50, damping: float = 1e-4):
    """Position IK for one body origin: q with fk(q)[body] ~ target_pos, by
    damped least squares. q0 (B, nq), target_pos (B, 3) or (3,); returns
    (q, err) with err (B,) the remaining distance."""
    mp = IKMapping(model, [body], iters=iters, damping=damping)
    target = torch.as_tensor(target_pos, dtype=q0.dtype, device=q0.device)
    q = mp.unmap_pos(target, q0)
    err = torch.linalg.vector_norm(mp.map_pos(q) - target, dim=-1)
    return q, err


class IKMapping:
    """Task-space mapping: z = the world positions of the selected body
    origins, (B, 3 len(bodies)). `unmap_pos` solves the IK by damped
    Gauss-Newton on the differentiable FK."""

    def __init__(self, model: Model, bodies, iters: int = 30, damping: float = 1e-4):
        self.model = model
        self.bodies = tuple(bodies)
        self.iters = iters
        self.damping = damping

    def map_pos(self, q):
        """(B, 3 len(bodies)) world positions of the selected body origins."""
        _, p = K.fk(self.model, q)
        return torch.cat([p[..., b, :] for b in self.bodies], dim=-1)

    def map_vel(self, q, v):
        """Task-space velocity through the point Jacobian: (B, 3 len(bodies))."""
        return (self.jacobian(q) @ v.unsqueeze(-1)).squeeze(-1)

    def jacobian(self, q):
        """(B, 3 len(bodies), nv) task Jacobian in tangent coordinates."""
        return _tangent_jacobian(self.model, q, self.map_pos)

    def unmap_pos(self, z, q_guess):
        """Damped-least-squares IK from q_guess (B, nq): q with map_pos(q) ~ z."""
        q = q_guess
        for _ in range(self.iters):
            dq = _dls_step(self.jacobian(q), z - self.map_pos(q), self.damping)
            q = D.integrate_positions(self.model, q, dq, 1.0)
        return q


class HierarchicalIK:
    """Whole-body IK over prioritized task levels with nullspace projection:
    each level is a list of (body, offset) point tasks; a lower level moves
    only within the nullspace of the levels above it.

    levels: [[(body, offset_xyz), ...], ...], highest priority first.
    solve(targets, q0): targets, one per level, each (n_tasks, 3) or
    (B, n_tasks, 3) world targets; q0 (B, nq).
    """

    def __init__(self, model: Model, levels, iters: int = 40, damping: float = 1e-4,
                 step: float = 1.0):
        self.model = model
        self.levels = [tuple((int(b), tuple(float(x) for x in off)) for (b, off) in lvl)
                       for lvl in levels]
        self.iters = iters
        self.damping = damping
        self.step = step

    def _level_pos(self, q, lvl):
        R, p = K.fk(self.model, q)
        return torch.cat([tf_apply(R[..., b, :, :], p[..., b, :],
                                   torch.tensor(off, dtype=q.dtype, device=q.device))
                          for (b, off) in lvl], dim=-1)

    def _level_jac(self, q, lvl):
        return _tangent_jacobian(self.model, q, lambda x: self._level_pos(x, lvl))

    def solve(self, targets, q0):
        """Returns (q (B, nq), per-level error norms (B, levels))."""
        m, dtype, dev = self.model, q0.dtype, q0.device
        B = q0.shape[0]
        zs = [torch.as_tensor(t, dtype=dtype, device=dev).reshape(-1, len(lvl) * 3).expand(B, -1)
              for t, lvl in zip(targets, self.levels)]
        eye = torch.eye(m.nv, dtype=dtype, device=dev)
        q = q0
        for _ in range(self.iters):
            dq = torch.zeros(B, m.nv, dtype=dtype, device=dev)
            N = eye.expand(B, -1, -1)  # nullspace of the levels above
            for lvl, z in zip(self.levels, zs):
                err = z - self._level_pos(q, lvl)
                Jl = self._level_jac(q, lvl)
                J = Jl @ N  # restricted to the remaining freedom
                H = J @ J.transpose(-1, -2) + self.damping * torch.eye(J.shape[-2], dtype=dtype, device=dev)
                rhs = (err - (Jl @ dq.unsqueeze(-1)).squeeze(-1)).unsqueeze(-1)
                dq = dq + (N @ (J.transpose(-1, -2) @ torch.linalg.solve(H, rhs))).squeeze(-1)
                # shrink the nullspace: N <- N (I - J+ J)
                N = N @ (eye - J.transpose(-1, -2) @ torch.linalg.solve(H, J))
            q = D.integrate_positions(m, q, self.step * dq, 1.0)
        errs = torch.stack([torch.linalg.vector_norm(z - self._level_pos(q, lvl), dim=-1)
                            for lvl, z in zip(self.levels, zs)], dim=-1)
        return q, errs
