"""Constraint assembly: contacts + joint rows -> one boxed LCP, batch-first.

Counterpart of diffdart_tpu/constraints/assembly.py. Row layout (static):

  [ nc normals | nc tangent-1 | nc tangent-2 | 2*nlim limits |
    nservo servo rows | nfric joint-friction rows ]

fidx couples each tangent row to its normal row (-1 elsewhere). Servo rows
drive a dof's velocity to its target within +-force_limit*dt, joint-friction
rows drive it to zero within +-joint_friction*dt. The ball, weld and mimic
rows raise NotImplementedError (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from diffdart_tpu_torch.collision.collide import Contacts, contact_slots, effective_contacts
from diffdart_tpu_torch.dynamics.model import Model
from diffdart_tpu_torch.math.lie import _mv, cross


class LCPData(NamedTuple):
    J: torch.Tensor  # (B, D, nv) constraint Jacobian
    A: torch.Tensor  # (B, D, D)
    b: torch.Tensor  # (B, D)
    lo: torch.Tensor  # (B, D)
    hi: torch.Tensor  # (B, D)
    mu: torch.Tensor  # (B, D)
    fidx: torch.Tensor  # (D,) long, the same for every env
    valid: torch.Tensor  # (B, D) bool


def check_rows(model: Model) -> None:
    if model.ball_pairs or model.weld_pairs or model.mimic_pairs:
        raise NotImplementedError(
            "ball, weld and mimic constraint rows are not ported to the torch vmap stack yet "
            "(ROADMAP Queue 1 item 9)")


def static_fidx(model: Model) -> tuple:
    """The static friction-index row layout as a Python tuple (it selects
    the sweep kernel's coupling)."""
    check_rows(model)
    nc = effective_contacts(model)
    rest = 2 * len(model.limited_dofs) + len(model.servo_dofs) + len(model.friction_dofs)
    return tuple([-1] * nc + list(range(nc)) + list(range(nc)) + [-1] * rest)


def tangent_basis(n):
    """Deterministic orthonormal (t1, t2) perpendicular to n (..., 3): the
    world axis least aligned with n, crossed with n."""
    ax = torch.argmin(torch.abs(n), dim=-1)
    e = torch.eye(3, dtype=n.dtype, device=n.device)[ax]
    t1 = cross(n, e)
    t1 = t1 / torch.linalg.norm(t1, dim=-1, keepdim=True)
    return t1, cross(n, t1)


def point_jacobian(Sw, mask_a, mask_b, pos):
    """(B, nv, 3) Jacobian of the relative velocity of world point pos (B,
    3) between bodies a and b."""
    lin = Sw[..., 3:] + cross(Sw[..., :3], pos.unsqueeze(-2))
    return (mask_a - mask_b).unsqueeze(-1) * lin


def _unit_rows(idx, nv, like):
    """(len(idx), nv) rows of the identity."""
    return torch.eye(nv, dtype=like.dtype, device=like.device)[list(idx)]


def assemble_constraints(model: Model, contacts: Contacts, Sw, mask, Minv, v_star, v_pre, qt, dt,
                         R_body=None, p_body=None, body_a=None, body_b=None) -> LCPData:
    """Build the boxed LCP over [normals | tangents1 | tangents2 | limits |
    servo | joint friction] for a batch of envs.

    Sw (B, nv, 6) world Jacobian columns; mask (nbody, nv) ancestor mask;
    Minv (B, nv, nv); v_star the unconstrained end-of-step velocity and
    v_pre the pre-step velocity (B, nv); qt (B, nv) tangent positions (for
    the limits); body_a, body_b (nc,) per-slot body indices (-1 = world),
    by default the static slot layout."""
    check_rows(model)
    dtype, dev = v_star.dtype, v_star.device
    batch = v_star.shape[:-1]
    nv = model.nv
    nc = contacts.pos.shape[-2]
    if body_a is None or body_b is None:
        sa, sb = contact_slots(model)
        body_a = torch.tensor(sa, dtype=torch.long, device=dev)
        body_b = torch.tensor(sb, dtype=torch.long, device=dev)
    lim, servo, fric = list(model.limited_dofs), list(model.servo_dofs), list(model.friction_dofs)
    nlim, nservo, nfric = len(lim), len(servo), len(fric)

    rows = []
    if nc:
        t1, t2 = tangent_basis(contacts.normal)
        nb = mask.shape[0]
        mask_pad = torch.cat([mask, torch.zeros(1, nv, dtype=dtype, device=dev)], dim=0)
        ma = mask_pad[torch.where(body_a < 0, nb, body_a)]  # (nc, nv)
        mb = mask_pad[torch.where(body_b < 0, nb, body_b)]
        lin = Sw[..., None, :, 3:] + cross(Sw[..., None, :, :3], contacts.pos[..., :, None, :])
        Jp = (ma - mb).unsqueeze(-1) * lin  # (B, nc, nv, 3)
        J_n = torch.einsum("xcvk,xck->xcv", Jp, contacts.normal)
        J_t1 = torch.einsum("xcvk,xck->xcv", Jp, t1)
        J_t2 = torch.einsum("xcvk,xck->xcv", Jp, t2)
        rows += [J_n, J_t1, J_t2]
    if nlim:
        e = _unit_rows(lim, nv, v_star).expand(*batch, nlim, nv)
        rows += [e, -e]
    if nservo:
        rows.append(_unit_rows(servo, nv, v_star).expand(*batch, nservo, nv))
    if nfric:
        rows.append(_unit_rows(fric, nv, v_star).expand(*batch, nfric, nv))
    D = 3 * nc + 2 * nlim + nservo + nfric
    J = torch.cat(rows, dim=-2) if rows else v_star.new_zeros(*batch, 0, nv)

    A = J @ Minv @ J.transpose(-1, -2)
    A = A + model.contact_cfm * torch.eye(D, dtype=dtype, device=dev)

    # b / bounds / fidx / validity; the error-correction velocity is capped
    # so deep initial penetrations do not launch bodies
    erp_vel_cap = 2.0
    slop = 1e-5
    b_parts, lo_parts, hi_parts, mu_parts, fidx_parts, valid_parts = [], [], [], [], [], []

    def full(n, x):
        return torch.full((*batch, n), x, dtype=dtype, device=dev)

    if nc:
        v_n_pre = _mv(J_n, v_pre)
        push = torch.clamp(model.baumgarte_erp * torch.clamp(contacts.depth - slop, min=0.0) / dt,
                           max=erp_vel_cap)
        bounce = contacts.restitution * torch.clamp(-v_n_pre - 0.01, min=0.0)
        target = torch.maximum(push, bounce)
        b_parts += [_mv(J_n, v_star) - target, _mv(J_t1, v_star), _mv(J_t2, v_star)]
        zero = full(nc, 0.0)
        lo_parts += [zero, zero, zero]  # friction bounds come from the fidx coupling
        hi_parts += [full(nc, float("inf")), zero, zero]
        fr = contacts.friction.expand(*batch, nc)
        mu_parts += [zero, fr, fr]
        fidx_parts += [[-1] * nc, list(range(nc)), list(range(nc))]
        valid_parts += [contacts.valid] * 3
    if nlim:
        q_j, v_j = qt[..., lim], v_pre[..., lim]
        lo_lim, hi_lim = model.q_lo[lim], model.q_hi[lim]
        viol_lo = lo_lim - q_j
        act_lo = (viol_lo > 0) | (lo_lim - (q_j + dt * v_j) > 0)
        target_lo = torch.clamp(model.baumgarte_erp * torch.clamp(viol_lo, min=0.0) / dt,
                                max=erp_vel_cap)
        viol_hi = q_j - hi_lim
        act_hi = (viol_hi > 0) | ((q_j + dt * v_j) - hi_lim > 0)
        target_hi = torch.clamp(model.baumgarte_erp * torch.clamp(viol_hi, min=0.0) / dt,
                                max=erp_vel_cap)
        b_parts += [v_star[..., lim] - target_lo, -v_star[..., lim] - target_hi]
        zero, infl = full(nlim, 0.0), full(nlim, float("inf"))
        lo_parts += [zero, zero]
        hi_parts += [infl, infl]
        mu_parts += [zero, zero]
        fidx_parts += [[-1] * nlim] * 2
        valid_parts += [act_lo, act_hi]
    for dofs, target, bound in ((servo, model.servo_target, model.force_limit),
                                (fric, None, model.joint_friction)):
        if not dofs:
            continue
        vs = v_star[..., dofs]
        b_parts.append(vs - target[dofs] if target is not None else vs)
        lo_parts.append((-bound[dofs] * dt).expand(*batch, len(dofs)))
        hi_parts.append((bound[dofs] * dt).expand(*batch, len(dofs)))
        mu_parts.append(full(len(dofs), 0.0))
        fidx_parts.append([-1] * len(dofs))
        valid_parts.append(torch.ones(*batch, len(dofs), dtype=torch.bool, device=dev))

    def cat(parts):
        return torch.cat(parts, dim=-1) if parts else full(0, 0.0)

    b, lo, hi, mu = cat(b_parts), cat(lo_parts), cat(hi_parts), cat(mu_parts)
    fidx = torch.tensor([f for part in fidx_parts for f in part], dtype=torch.long, device=dev)
    valid = (torch.cat(valid_parts, dim=-1) if valid_parts
             else torch.zeros(*batch, 0, dtype=torch.bool, device=dev))
    # invalid rows: lo = hi = 0, friction coupling severed
    lo = torch.where(valid, lo, 0.0)
    hi = torch.where(valid, hi, 0.0)
    mu = torch.where(valid, mu, 0.0)
    return LCPData(J=J, A=A, b=b, lo=lo, hi=hi, mu=mu, fidx=fidx, valid=valid)
