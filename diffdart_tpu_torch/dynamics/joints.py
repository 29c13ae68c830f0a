"""Per-joint-type kinematic maps: q -> joint transform, motion subspace S.

Counterpart of diffdart_tpu/dynamics/joints.py for the joint types of the
fused subset: WELD, REVOLUTE, PRISMATIC, PLANAR, FREE and BALL. q is the
joint's slice with a leading batch axis, (B, nq_j); model vectors (axis,
axis2) are unbatched and broadcast. The other joint types (SCREW,
UNIVERSAL, EULER, TRANSLATIONAL, TRANSLATIONAL2D) raise NotImplementedError
(ROADMAP Queue 1 item 9).

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
SUPPORTED = (_J.WELD, _J.REVOLUTE, _J.PRISMATIC, _J.PLANAR, _J.FREE, _J.BALL)


def check_joint(jtype: int) -> None:
    if jtype not in SUPPORTED:
        raise NotImplementedError(
            f"joint type {jtype} is not ported to the torch vmap stack yet "
            f"(ROADMAP Queue 1 item 9); supported: WELD, REVOLUTE, PRISMATIC, PLANAR, FREE, BALL")


def _eye(q):
    return torch.eye(3, dtype=q.dtype, device=q.device).expand(*q.shape[:-1], 3, 3)


def _zeros3(q):
    return torch.zeros(*q.shape[:-1], 3, dtype=q.dtype, device=q.device)


def joint_transform(jtype: int, q, axis, axis2):
    """(R, p) of the child frame in the predecessor frame; q: (B, nq_j)."""
    check_joint(jtype)
    if jtype == _J.WELD:
        return _eye(q), _zeros3(q)
    if jtype == _J.REVOLUTE:
        return exp_so3(axis * q[..., :1]), _zeros3(q)
    if jtype == _J.PRISMATIC:
        return _eye(q), axis * q[..., :1]
    if jtype == _J.BALL:
        return quat_to_mat(quat_normalize(q)), _zeros3(q)
    if jtype == _J.PLANAR:
        n = cross(axis, axis2)
        return exp_so3(n * q[..., 2:3]), axis * q[..., :1] + axis2 * q[..., 1:2]
    # FREE
    return quat_to_mat(quat_normalize(q[..., :4])), q[..., 4:]


def motion_subspace(jtype: int, q, axis, axis2):
    """S: (B, nv_j, 6) joint motion subspace in the child body frame."""
    check_joint(jtype)
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
    if jtype == _J.BALL:
        return torch.eye(3, 6, dtype=dt, device=dev).expand(*B, 3, 6)
    if jtype == _J.PLANAR:
        n = cross(axis, axis2)
        RT = exp_so3(-n * q[..., 2:3])
        return torch.stack([row(z, _mv(RT, axis)), row(z, _mv(RT, axis2)), row(n, z)], dim=-2)
    # FREE: (omega_child, v_child)
    return torch.eye(6, dtype=dt, device=dev).expand(*B, 6, 6)


def motion_subspace_dot(jtype: int, q, qdot, axis, axis2):
    """dS/dq . qdot, (B, nv_j, 6), for the joints whose S depends on q (of
    the ported types, PLANAR only; None for the others). The JAX package
    takes it with jax.jvp of motion_subspace; here it is written out:
    d/dq2 exp_so3(-n q2) = -skew(n) exp_so3(-n q2), exact for the matrix
    exponential of a fixed generator."""
    if jtype != _J.PLANAR:
        return None
    n = cross(axis, axis2)
    RT = exp_so3(-n * q[..., 2:3])
    dRT = -(skew(n) @ RT) * qdot[..., 2:3, None]
    z = _zeros3(q)
    return torch.stack([torch.cat([z, _mv(dRT, axis.expand_as(z))], -1),
                        torch.cat([z, _mv(dRT, axis2.expand_as(z))], -1),
                        torch.cat([z, z], -1)], dim=-2)


def integrate_joint(jtype: int, q, vj, dt):
    """q_{t+1} = q (+) vj dt per joint type (geometric for BALL and FREE)."""
    check_joint(jtype)
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
    check_joint(jtype)
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
