"""Constraint assembly: contacts, joint rows and bilateral rows -> one
boxed LCP, batch-first.

Counterpart of diffdart_tpu/constraints/assembly.py. Row layout (static):

  [ nc normals | nc tangent-1 | nc tangent-2 | 2*nlim limits |
    nservo servo rows | nfric joint-friction rows |
    3*nball ball rows | 6*nweld weld rows | nmimic mimic rows ]

fidx couples each tangent row to its normal row (-1 elsewhere). Servo rows
drive a dof's velocity to its target within +-force_limit*dt, joint-friction
rows drive it to zero within +-joint_friction*dt. Ball, weld and mimic rows
are bilateral (lo = -inf, hi = +inf), Baumgarte-stabilised equalities: a
ball row holds the relative velocity of its anchor point at zero, a weld
adds the relative angular velocity, a mimic row q_d - mult q_s.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from diffdart_tpu_torch.collision.collide import Contacts, contact_slots, effective_contacts
from diffdart_tpu_torch.dynamics.model import Model
from diffdart_tpu_torch.math.lie import _mv, cross, log_so3, tf_apply


class LCPData(NamedTuple):
    J: torch.Tensor  # (B, D, nv) constraint Jacobian
    A: torch.Tensor  # (B, D, D)
    b: torch.Tensor  # (B, D)
    lo: torch.Tensor  # (B, D)
    hi: torch.Tensor  # (B, D)
    mu: torch.Tensor  # (B, D)
    fidx: torch.Tensor  # (D,) long, the same for every env
    valid: torch.Tensor  # (B, D) bool


def static_fidx(model: Model) -> tuple:
    """The static friction-index row layout as a Python tuple (it selects
    the sweep kernel's coupling), of length D, the bilateral rows
    included."""
    nc = effective_contacts(model)
    rest = (2 * len(model.limited_dofs) + len(model.servo_dofs) + len(model.friction_dofs)
            + 3 * len(model.ball_pairs) + 6 * len(model.weld_pairs) + len(model.mimic_pairs))
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
    servo | joint friction | ball | weld | mimic] for a batch of envs.

    Sw (B, nv, 6) world Jacobian columns; mask (nbody, nv) ancestor mask;
    Minv (B, nv, nv); v_star the unconstrained end-of-step velocity and
    v_pre the pre-step velocity (B, nv); qt (B, nv) tangent positions (for
    the limits); body_a, body_b (nc,) per-slot body indices (-1 = world),
    by default the static slot layout; R_body (B, nbody, 3, 3) and p_body
    (B, nbody, 3) the body poses (for the ball and weld rows)."""
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
    # bilateral ball / weld rows and their stabilisation errors
    zero_mask = torch.zeros(nv, dtype=dtype, device=dev)

    def bmask(bi):
        return zero_mask if bi < 0 else mask[bi]

    def pose(bi):
        if bi < 0:
            return torch.eye(3, dtype=dtype, device=dev), zero_mask.new_zeros(3)
        return R_body[..., bi, :, :], p_body[..., bi, :]

    def anchor_rows(ba, bb, anchor_a, anchor_b):
        """The 3 rows of the relative velocity at the anchors' midpoint, the
        anchors' gap, and the two body rotations."""
        (Ra, pa), (Rb, pb) = pose(ba), pose(bb)
        aw, bw = tf_apply(Ra, pa, anchor_a), tf_apply(Rb, pb, anchor_b)
        Jp = point_jacobian(Sw, bmask(ba), bmask(bb), (0.5 * (aw + bw)).expand(*batch, 3))
        return Jp.transpose(-1, -2), (aw - bw).expand(*batch, 3), Ra, Rb

    bi_errs = []
    for k, (ba, bb) in enumerate(model.ball_pairs):
        Jp, gap, _, _ = anchor_rows(ba, bb, model.ball_anchor_a[k], model.ball_anchor_b[k])
        rows.append(Jp)
        bi_errs.append(gap)
    for k, (ba, bb) in enumerate(model.weld_pairs):
        Jp, gap, Ra, Rb = anchor_rows(ba, bb, model.weld_anchor_a[k], model.weld_anchor_b[k])
        J_ang = (bmask(ba) - bmask(bb)).unsqueeze(-1) * Sw[..., :3]
        rows += [Jp, J_ang.transpose(-1, -2)]
        # orientation error: R_a rel R_b^T should be the identity
        E_rot = Ra @ model.weld_rel_rot[k] @ Rb.transpose(-1, -2)
        bi_errs += [gap, log_so3(E_rot).expand(*batch, 3)]
    mimic = list(model.mimic_pairs)
    nmimic = len(mimic)
    if nmimic:
        md, ms = [p[0] for p in mimic], [p[1] for p in mimic]
        Jmi = _unit_rows(md, nv, v_star) - model.mimic_mult[:, None] * _unit_rows(ms, nv, v_star)
        rows.append(Jmi.expand(*batch, nmimic, nv))
    nbi = 3 * len(model.ball_pairs) + 6 * len(model.weld_pairs)
    D = 3 * nc + 2 * nlim + nservo + nfric + nbi + nmimic
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

    start = 3 * nc + 2 * nlim + nservo + nfric
    if nbi:
        err = torch.cat(bi_errs, dim=-1)
        b_parts.append(_mv(J[..., start:start + nbi, :], v_star) + (model.baumgarte_erp / dt) * err)
    if nmimic:
        # position error q_d - mult q_s - offset, corrected at the erp rate
        # within the velocity cap of the other stabilised rows
        err = qt[..., md] - model.mimic_mult * qt[..., ms] - model.mimic_offset
        corr = torch.clamp(model.baumgarte_erp * err / dt, -erp_vel_cap, erp_vel_cap)
        b_parts.append(_mv(J[..., start + nbi:start + nbi + nmimic, :], v_star) + corr)
    for n in (nbi, nmimic):
        if n:
            lo_parts.append(full(n, -float("inf")))
            hi_parts.append(full(n, float("inf")))
            mu_parts.append(full(n, 0.0))
            fidx_parts.append([-1] * n)
            valid_parts.append(torch.ones(*batch, n, dtype=torch.bool, device=dev))

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
