"""Articulated-body dynamics of the vmap stack, batch-first: mass matrix,
bias forces, joint forces (explicit and implicit), forward and inverse
dynamics, the energies and geometric position integration.

Counterpart of diffdart_tpu/dynamics/dynamics.py (the world-frame
composite-rigid-body formulation: M = sum_b J_b^T I_b^w J_b, C = sum_b
J_b^T (I_b^w a_b^vp + V_b x* I_b^w V_b)). Per-env tensors carry a leading
batch axis (q (B, nq), v (B, nv)); model tensors are unbatched and
broadcast, so gradients with respect to them (mass, inertia, ...) flow.
"""
from __future__ import annotations

import torch

from diffdart_tpu_torch.dynamics import kinematics as K
from diffdart_tpu_torch.dynamics.joints import integrate_joint, joint_difference
from diffdart_tpu_torch.dynamics.model import JointType, Model
from diffdart_tpu_torch.math.spatial import force_cross, spatial_inertia, transform_inertia
from diffdart_tpu_torch.ops.smalllinalg import spd_solve_small


def _mask(model: Model, like):
    return torch.as_tensor(model.ancestor_mask, dtype=like.dtype, device=like.device)


def kinematics_cache(model: Model, q, v):
    """Shared per-step kinematic quantities: R (B, nbody, 3, 3), p (B,
    nbody, 3), Sw (B, nv, 6), mask (nbody, nv), V (B, nbody, 6), I_w (B,
    nbody, 6, 6)."""
    R, p = K.fk(model, q)
    Sw = K.world_jacobian(model, q, R, p)
    mask = _mask(model, q)
    V = K.body_velocities(model, Sw, v, mask)
    I_body = spatial_inertia(model.mass, model.com, model.inertia)
    I_w = transform_inertia(R, p, I_body)
    return dict(R=R, p=p, Sw=Sw, mask=mask, V=V, I_w=I_w)


def _body_jacobians(cache):
    """J_b = mask[b] * Sw: (B, nbody, nv, 6)."""
    return cache["mask"][:, :, None] * cache["Sw"].unsqueeze(-3)


def mass_matrix(model: Model, q, cache=None):
    """(B, nv, nv) joint-space inertia matrix."""
    if cache is None:
        cache = kinematics_cache(model, q, torch.zeros(*q.shape[:-1], model.nv, dtype=q.dtype,
                                                       device=q.device))
    J = _body_jacobians(cache)
    M = torch.einsum("xbnu,xbuw,xbmw->xnm", J, cache["I_w"], J)
    return M + torch.diag(model.armature)


def bias_forces(model: Model, q, v, cache=None):
    """(B, nv) Coriolis + centrifugal + gravity generalised forces (no joint
    damping or springs)."""
    if cache is None:
        cache = kinematics_cache(model, q, v)
    R, p, Sw, mask, V, I_w = (cache[k] for k in ("R", "p", "Sw", "mask", "V", "I_w"))
    sdot = K.world_jacobian_dot_terms(model, q, v, R, p, Sw, V)
    a_grav = torch.cat([torch.zeros_like(model.gravity), model.gravity])
    a_vp = (mask * v.unsqueeze(-2)) @ sdot - a_grav
    F = (I_w @ a_vp.unsqueeze(-1)).squeeze(-1) + force_cross(V, (I_w @ V.unsqueeze(-1)).squeeze(-1))
    return torch.einsum("xbnu,xbu->xn", _body_jacobians(cache), F)


def q_tangent(model: Model, q):
    """(B, nv) tangent coordinates of q (log map for quaternion joints)."""
    return position_difference(model, _neutral_like(model, q), q)


def _neutral_like(model: Model, q):
    qn = torch.zeros_like(q)
    for i in range(model.nbody):
        if model.jtype[i] in (JointType.BALL, JointType.FREE):
            qn[..., model.q_off[i]] = 1.0
    return qn


def joint_forces(model: Model, q, v):
    """(B, nv) explicit joint forces: viscous damping and linear springs."""
    f = -model.damping * v
    if model.has_springs:
        f = f - model.spring_stiff * (q_tangent(model, q) - model.q_rest)
    return f


def forward_dynamics(model: Model, q, v, tau, f_ext=None, cache=None):
    """(B, nv) unconstrained accelerations qdd = M^-1 (tau + joint forces +
    f_ext - C); f_ext an optional extra generalised force."""
    if cache is None:
        cache = kinematics_cache(model, q, v)
    M = mass_matrix(model, q, cache)
    C = bias_forces(model, q, v, cache)
    rhs = tau + joint_forces(model, q, v) - C
    if f_ext is not None:
        rhs = rhs + f_ext
    return spd_solve_small(M, rhs)


def inverse_dynamics(model: Model, q, v, qdd):
    """(B, nv) tau = M qdd + C - joint forces."""
    cache = kinematics_cache(model, q, v)
    M = mass_matrix(model, q, cache)
    C = bias_forces(model, q, v, cache)
    return (M @ qdd.unsqueeze(-1)).squeeze(-1) + C - joint_forces(model, q, v)


def kinetic_energy(model: Model, q, v):
    """(B,) kinetic energy 1/2 sum_b V_b^T I_b^w V_b."""
    cache = kinematics_cache(model, q, v)
    return 0.5 * torch.einsum("xbu,xbuw,xbw->x", cache["V"], cache["I_w"], cache["V"])


def potential_energy(model: Model, q):
    """(B,) gravitational potential energy -sum_b m_b g . c_b."""
    R, p = K.fk(model, q)
    coms = K.com_positions(model, R, p)
    return -torch.einsum("b,xbi,i->x", model.mass, coms, model.gravity)


def implicit_joint_terms(model: Model, q, v, dt):
    """Implicit (backward-Euler) spring/damper treatment: returns
    (M_extra_diag, f) with M_eff = M + diag(dt d + dt^2 k) and
    f = -d v - k (qt - q_rest) - dt k v."""
    d = model.damping
    f = -d * v
    extra = dt * d
    if model.has_springs:
        k = model.spring_stiff
        f = f - k * (q_tangent(model, q) - model.q_rest) - dt * k * v
        extra = extra + dt * dt * k
    return extra, f


def integrate_positions(model: Model, q, v, dt):
    """q' = q (+) v dt per joint (quaternion exp for BALL and FREE)."""
    parts = []
    for i in range(model.nbody):
        lo_q, nq_i = model.q_off[i], model.body_nq(i)
        lo_v, nv_i = model.v_off[i], model.body_nv(i)
        parts.append(integrate_joint(model.jtype[i], q[..., lo_q:lo_q + nq_i],
                                     v[..., lo_v:lo_v + nv_i], dt))
    return torch.cat(parts, dim=-1) if parts else q


def position_difference(model: Model, q1, q2):
    """(B, nv) tangent-space difference q2 (-) q1."""
    parts = []
    for i in range(model.nbody):
        lo_q, nq_i = model.q_off[i], model.body_nq(i)
        parts.append(joint_difference(model.jtype[i], q1[..., lo_q:lo_q + nq_i],
                                      q2[..., lo_q:lo_q + nq_i]))
    if not parts:
        return q1[..., :0]
    return torch.cat(parts, dim=-1)
