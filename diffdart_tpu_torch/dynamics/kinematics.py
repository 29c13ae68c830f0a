"""Forward kinematics and world-frame Jacobian quantities, batch-first.

Counterpart of diffdart_tpu/dynamics/kinematics.py: a sweep over the static
topology, unrolled in Python, each body's work one batched op over the
leading env axis. World quantities are Plucker coordinates at the world
origin, so each dof's Jacobian column is one 6-vector (Sw).
"""
from __future__ import annotations

import torch

from diffdart_tpu_torch.dynamics.joints import joint_transform, motion_subspace, motion_subspace_dot
from diffdart_tpu_torch.dynamics.model import Model
from diffdart_tpu_torch.math.lie import tf_compose
from diffdart_tpu_torch.math.spatial import motion_cross, transform_motion


def _body_q(model: Model, q, i: int):
    lo = model.q_off[i]
    return q[..., lo:lo + model.body_nq(i)]


def fk(model: Model, q):
    """World pose of every body frame: R (B, nbody, 3, 3), p (B, nbody, 3)."""
    Rs, ps = [], []
    for i in range(model.nbody):
        Rj, pj = joint_transform(model.jtype[i], _body_q(model, q, i), model.axis[i], model.axis2[i],
                                 model.screw_pitch[i])
        R_pc, p_pc = tf_compose(model.X_rot[i], model.X_pos[i], Rj, pj)
        par = model.parent[i]
        if par >= 0:
            R_pc, p_pc = tf_compose(Rs[par], ps[par], R_pc, p_pc)
        Rs.append(R_pc)
        ps.append(p_pc)
    return torch.stack(Rs, dim=-3), torch.stack(ps, dim=-2)


def world_jacobian(model: Model, q, R, p):
    """Per-dof world Jacobian columns Sw: (B, nv, 6)."""
    cols = []
    for i in range(model.nbody):
        S = motion_subspace(model.jtype[i], _body_q(model, q, i), model.axis[i], model.axis2[i],
                            model.screw_pitch[i])
        if S.shape[-2]:
            cols.append(transform_motion(R[..., i, None, :, :], p[..., i, None, :], S))
    if not cols:
        return q.new_zeros(*q.shape[:-1], 0, 6)
    return torch.cat(cols, dim=-2)


def world_jacobian_dot_terms(model: Model, q, v, R, p, Sw, V):
    """Sw_dot (B, nv, 6): ad_{V[b(j)]} Sw[j], plus Ad_X (dS/dq qdot) for the
    joints whose subspace depends on q."""
    dof_body = list(model.dof_body)
    if not dof_body:
        return torch.zeros_like(Sw)
    sdot = motion_cross(V[..., dof_body, :], Sw)
    for i in range(model.nbody):
        lo_v, nv_i = model.v_off[i], model.body_nv(i)
        dS = motion_subspace_dot(model.jtype[i], _body_q(model, q, i), v[..., lo_v:lo_v + nv_i],
                                 model.axis[i], model.axis2[i])
        if dS is None:
            continue
        extra = transform_motion(R[..., i, None, :, :], p[..., i, None, :], dS)
        sdot = torch.cat([sdot[..., :lo_v, :], sdot[..., lo_v:lo_v + nv_i, :] + extra,
                          sdot[..., lo_v + nv_i:, :]], dim=-2)
    return sdot


def body_velocities(model: Model, Sw, v, mask):
    """World spatial velocity of each body: (B, nbody, 6) = (mask * v) @ Sw."""
    return (mask * v.unsqueeze(-2)) @ Sw


def com_positions(model: Model, R, p):
    """World COM of each body: (B, nbody, 3)."""
    return (R @ model.com.unsqueeze(-1)).squeeze(-1) + p


def total_com(model: Model, R, p):
    """(B, 3) world centre of mass of the whole mechanism."""
    coms = com_positions(model, R, p)
    return torch.einsum("b,xbi->xi", model.mass, coms) / model.mass.sum()
