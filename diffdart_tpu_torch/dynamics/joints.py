"""Per-joint-type kinematic maps: q -> joint transform, motion subspace S,
its time derivative, position integration and difference, batch-first.

Counterpart of diffdart_tpu/dynamics/joints.py, for every joint type: WELD,
REVOLUTE, PRISMATIC, SCREW, UNIVERSAL, BALL, EULER, TRANSLATIONAL,
TRANSLATIONAL2D, PLANAR and FREE. q is the joint's slice with a leading
batch axis, (B, nq_j); model vectors (axis, axis2, the screw pitch) are
unbatched and broadcast.

Conventions: joint_transform returns (R, p), the child frame in the joint's
predecessor frame; motion_subspace returns S (B, nv_j, 6), rows are spatial
motion vectors (angular-first) in the child frame.
"""
from __future__ import annotations

import torch

from diffdart_tpu_torch.dynamics.model import JointType
from diffdart_tpu_torch.math.lie import (
    _mv, cross, exp_so3, quat_conj, quat_exp, quat_log, quat_mul, quat_normalize, quat_to_mat,
    skew)

_J = JointType


def _eye(q):
    return torch.eye(3, dtype=q.dtype, device=q.device).expand(*q.shape[:-1], 3, 3)


def _zeros3(q):
    return torch.zeros(*q.shape[:-1], 3, dtype=q.dtype, device=q.device)


def _pitch(pitch, q):
    return torch.zeros((), dtype=q.dtype, device=q.device) if pitch is None else pitch


def joint_transform(jtype: int, q, axis, axis2, pitch=None):
    """(R, p) of the child frame in the predecessor frame; q: (B, nq_j);
    pitch: the SCREW joint's translation per radian (0-d; None = 0)."""
    if jtype == _J.WELD:
        return _eye(q), _zeros3(q)
    if jtype == _J.REVOLUTE:
        return exp_so3(axis * q[..., :1]), _zeros3(q)
    if jtype == _J.PRISMATIC:
        return _eye(q), axis * q[..., :1]
    if jtype == _J.SCREW:
        return exp_so3(axis * q[..., :1]), axis * (q[..., :1] * _pitch(pitch, q))
    if jtype == _J.UNIVERSAL:
        return exp_so3(axis * q[..., :1]) @ exp_so3(axis2 * q[..., 1:2]), _zeros3(q)
    if jtype == _J.BALL:
        return quat_to_mat(quat_normalize(q)), _zeros3(q)
    if jtype == _J.EULER:
        # intrinsic rotations about axis, axis2, then axis x axis2
        a3 = cross(axis, axis2)
        R = exp_so3(axis * q[..., :1]) @ exp_so3(axis2 * q[..., 1:2]) @ exp_so3(a3 * q[..., 2:3])
        return R, _zeros3(q)
    if jtype == _J.TRANSLATIONAL:
        return _eye(q), q
    if jtype == _J.TRANSLATIONAL2D:
        return _eye(q), axis * q[..., :1] + axis2 * q[..., 1:2]
    if jtype == _J.PLANAR:
        n = cross(axis, axis2)
        return exp_so3(n * q[..., 2:3]), axis * q[..., :1] + axis2 * q[..., 1:2]
    if jtype == _J.FREE:
        return quat_to_mat(quat_normalize(q[..., :4])), q[..., 4:]
    raise ValueError(f"unknown joint type {jtype}")


def motion_subspace(jtype: int, q, axis, axis2, pitch=None):
    """S: (B, nv_j, 6) joint motion subspace in the child body frame."""
    B = q.shape[:-1]
    dt, dev = q.dtype, q.device

    def row(w, v):
        w, v = torch.broadcast_tensors(w, v)
        return torch.cat([w, v], dim=-1).expand(*B, 6)

    if jtype == _J.WELD:
        return torch.zeros(*B, 0, 6, dtype=dt, device=dev)
    z = torch.zeros(3, dtype=dt, device=dev)
    if jtype == _J.REVOLUTE:
        return row(axis, z).unsqueeze(-2)
    if jtype == _J.PRISMATIC:
        return row(z, axis).unsqueeze(-2)
    if jtype == _J.SCREW:
        return row(axis, axis * _pitch(pitch, q)).unsqueeze(-2)
    if jtype == _J.UNIVERSAL:
        # child frame: the second axis fixed, the first rotated back through q2
        R2T = exp_so3(-axis2 * q[..., 1:2])
        return torch.stack([row(_mv(R2T, axis), z), row(axis2, z)], dim=-2)
    if jtype == _J.BALL:
        return torch.eye(3, 6, dtype=dt, device=dev).expand(*B, 3, 6)
    if jtype == _J.EULER:
        a3 = cross(axis, axis2)
        R3T, R2T = exp_so3(-a3 * q[..., 2:3]), exp_so3(-axis2 * q[..., 1:2])
        return torch.stack([row(_mv(R3T, _mv(R2T, axis)), z), row(_mv(R3T, axis2), z), row(a3, z)],
                           dim=-2)
    if jtype == _J.TRANSLATIONAL:
        return torch.eye(3, 6, dtype=dt, device=dev).roll(3, -1).expand(*B, 3, 6)
    if jtype == _J.TRANSLATIONAL2D:
        # translation axes fixed in the (non-rotating) predecessor = child frame
        return torch.stack([row(z, axis), row(z, axis2)], dim=-2)
    if jtype == _J.PLANAR:
        n = cross(axis, axis2)
        RT = exp_so3(-n * q[..., 2:3])
        return torch.stack([row(z, _mv(RT, axis)), row(z, _mv(RT, axis2)), row(n, z)], dim=-2)
    if jtype == _J.FREE:  # (omega_child, v_child)
        return torch.eye(6, dtype=dt, device=dev).expand(*B, 6, 6)
    raise ValueError(f"unknown joint type {jtype}")


def motion_subspace_dot(jtype: int, q, qdot, axis, axis2):
    """dS/dq . qdot, (B, nv_j, 6), for the joints whose S depends on q
    (UNIVERSAL, EULER, PLANAR; None for the others). The JAX package takes
    it with jax.jvp of motion_subspace; here it is written out:
    d/dt exp_so3(-a x) = -skew(a) exp_so3(-a x) xdot, exact for the matrix
    exponential of a fixed generator."""
    if jtype not in (_J.UNIVERSAL, _J.EULER, _J.PLANAR):
        return None
    z = _zeros3(q)

    def ang(w):
        return torch.cat([w, z], -1)

    def lin(v):
        return torch.cat([z, v], -1)

    def d_exp(a, x, xdot):  # d/dt exp_so3(-a x), (B, 3, 3)
        return -(skew(a) @ exp_so3(-a * x)) * xdot[..., None]

    if jtype == _J.UNIVERSAL:
        dR2T = d_exp(axis2, q[..., 1:2], qdot[..., 1:2])
        return torch.stack([ang(_mv(dR2T, axis.expand_as(z))), ang(z)], dim=-2)
    if jtype == _J.EULER:
        a3 = cross(axis, axis2)
        R3T, R2T = exp_so3(-a3 * q[..., 2:3]), exp_so3(-axis2 * q[..., 1:2])
        dR3T = d_exp(a3, q[..., 2:3], qdot[..., 2:3])
        dR2T = d_exp(axis2, q[..., 1:2], qdot[..., 1:2])
        a1 = axis.expand_as(z)
        w0 = _mv(dR3T, _mv(R2T, a1)) + _mv(R3T, _mv(dR2T, a1))
        return torch.stack([ang(w0), ang(_mv(dR3T, axis2.expand_as(z))), ang(z)], dim=-2)
    n = cross(axis, axis2)
    dRT = d_exp(n, q[..., 2:3], qdot[..., 2:3])
    return torch.stack([lin(_mv(dRT, axis.expand_as(z))), lin(_mv(dRT, axis2.expand_as(z))),
                        lin(z)], dim=-2)


def integrate_joint(jtype: int, q, vj, dt):
    """q_{t+1} = q (+) vj dt per joint type (geometric for BALL and FREE)."""
    if jtype == _J.WELD:
        return q
    if jtype == _J.BALL:
        return quat_normalize(quat_mul(quat_normalize(q), quat_exp(vj * dt)))
    if jtype == _J.FREE:
        quat = quat_normalize(q[..., :4])
        new_quat = quat_normalize(quat_mul(quat, quat_exp(vj[..., :3] * dt)))
        new_pos = q[..., 4:] + _mv(quat_to_mat(quat), vj[..., 3:]) * dt
        return torch.cat([new_quat, new_pos], dim=-1)
    return q + vj * dt


def joint_difference(jtype: int, q1, q2):
    """Tangent-space difference d with q1 (+) d ~ q2."""
    if jtype == _J.WELD:
        return q1[..., :0]
    if jtype == _J.BALL:
        return quat_log(quat_mul(quat_conj(quat_normalize(q1)), quat_normalize(q2)))
    if jtype == _J.FREE:
        quat1, quat2 = quat_normalize(q1[..., :4]), quat_normalize(q2[..., :4])
        dw = quat_log(quat_mul(quat_conj(quat1), quat2))
        R1T = quat_to_mat(quat1).transpose(-1, -2)
        return torch.cat([dw, _mv(R1T, q2[..., 4:] - q1[..., 4:])], dim=-1)
    return q2 - q1
