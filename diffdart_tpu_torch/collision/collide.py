"""World collision: static pair list -> fixed-size contact buffers, batched.

Counterpart of diffdart_tpu/collision/collide.py. The pair list and the
slots per pair are decided when the model is built (model.col_pairs), so
every env has the same contact layout with a validity mask. Pairs are
grouped by narrowphase function and each group runs as one batched call
over (env, member).

Ported pairs: sphere, capsule and box against a plane. Other primitive
pairs raise NotImplementedError (ROADMAP Queue 1 item 8); convex hulls,
`contact_budget` below the slot count and the `pair_budget` broadphase raise
too (Queue 1 item 6).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from diffdart_tpu_torch.collision import narrowphase as NP
from diffdart_tpu_torch.dynamics.model import GeomType, Model
from diffdart_tpu_torch.math.lie import tf_compose

_G = GeomType

# (typeA, typeB) -> (fn, n_slots) in canonical order; a pair stored the other
# way round runs with its geoms swapped into this order
_DISPATCH = {
    (_G.SPHERE, _G.PLANE): (NP.sphere_plane, 1),
    (_G.CAPSULE, _G.PLANE): (NP.capsule_plane, 2),
    (_G.BOX, _G.PLANE): (NP.box_plane, 8),
}


class Contacts(NamedTuple):
    """Fixed-size contact set, (B, nc, ...) per field. Per-slot body indices
    come from `contact_slots(model)`."""

    pos: torch.Tensor  # (B, nc, 3) world contact point
    normal: torch.Tensor  # (B, nc, 3) world normal, pushes body_a away from body_b
    depth: torch.Tensor  # (B, nc) penetration depth (> 0 = penetrating)
    valid: torch.Tensor  # (B, nc) bool
    friction: torch.Tensor  # (nc,)
    restitution: torch.Tensor  # (nc,)


def _pair_plan(model: Model):
    """Static narrowphase plan: per pair (kind, fn, slots, ga, gb, swapped)."""
    if model.pair_budget:
        raise NotImplementedError(
            "Model.pair_budget (the AABB broadphase) is not ported to the torch vmap stack yet "
            "(ROADMAP Queue 1 item 6)")
    plan = []
    for (a, b) in model.col_pairs:
        ta, tb = model.geom_type[a], model.geom_type[b]
        if _G.CONVEX in (ta, tb):
            raise NotImplementedError(
                "convex-hull pairs are not ported to the torch vmap stack yet (ROADMAP Queue 1 item 6)")
        if (ta, tb) in _DISPATCH:
            fn, k = _DISPATCH[(ta, tb)]
            plan.append(("prim", fn, k, a, b, False))
        elif (tb, ta) in _DISPATCH:
            fn, k = _DISPATCH[(tb, ta)]
            plan.append(("prim", fn, k, b, a, True))
        else:
            raise NotImplementedError(
                f"narrowphase for geom types ({ta},{tb}) is not ported to the torch vmap stack yet "
                f"(ROADMAP Queue 1 item 8); ported: sphere, capsule and box vs plane")
    return plan


def _grouped_plan(model: Model):
    """The pair plan grouped by narrowphase function, in first-seen order:
    [(kind, fn, k, members)] with members [(ga, gb, swapped), ...]. Slot
    order is group order (contact_slots and collide_world_with_bodies both
    derive from this)."""
    groups: dict = {}
    order = []
    for (kind, fn, k, ga, gb, swapped) in _pair_plan(model):
        if fn not in groups:
            groups[fn] = (kind, fn, k, [])
            order.append(fn)
        groups[fn][3].append((ga, gb, swapped))
    return [groups[key] for key in order]


def _group_cap(model: Model, kind: str, members) -> int:
    """Pairs from this group entering narrowphase: all of them (the
    pair_budget broadphase is not ported; _pair_plan raises for it)."""
    return len(members)


def max_contacts(model: Model) -> int:
    return sum(k * _group_cap(model, kind, members)
               for (kind, _, k, members) in _grouped_plan(model))


def effective_contacts(model: Model) -> int:
    """Contact slots entering the LCP. A contact budget below the slot count
    (top-k selection) is not ported and raises."""
    nc = max_contacts(model)
    if model.contact_budget and nc > model.contact_budget:
        raise NotImplementedError(
            "Model.contact_budget below the contact slot count is not ported to the torch vmap "
            "stack yet (ROADMAP Queue 1 item 6)")
    return nc


def select_contacts(model: Model, contacts: Contacts, body_a=None, body_b=None):
    """The LCP's contact set and per-slot body indices: the identity, since
    a cutting contact budget raises (effective_contacts)."""
    if body_a is None or body_b is None:
        sa, sb = contact_slots(model)
        dev = contacts.pos.device
        body_a = torch.tensor(sa, dtype=torch.long, device=dev)
        body_b = torch.tensor(sb, dtype=torch.long, device=dev)
    effective_contacts(model)
    return contacts, body_a, body_b


def contact_slots(model: Model):
    """Static per-slot metadata: (body_a, body_b) tuples of length
    max_contacts; body_a is the body pushed along +normal."""
    body_a, body_b = [], []
    for (_, fn, k, members) in _grouped_plan(model):
        for (ga, gb, swapped) in members:
            body_a += [model.geom_body[ga]] * k
            body_b += [model.geom_body[gb]] * k
    return tuple(body_a), tuple(body_b)


def geom_world_poses(model: Model, R_body, p_body):
    """World pose of each geom (lists of (B, 3, 3) / (B, 3)): body pose o
    local geom pose; world geoms (body -1) use their local pose."""
    batch = R_body.shape[:-3]
    Rs, ps = [], []
    for g in range(model.ngeom):
        b = model.geom_body[g]
        if b < 0:
            Rs.append(model.geom_rot[g].expand(*batch, 3, 3))
            ps.append(model.geom_pos[g].expand(*batch, 3))
        else:
            R, p = tf_compose(R_body[..., b, :, :], p_body[..., b, :], model.geom_rot[g],
                              model.geom_pos[g])
            Rs.append(R)
            ps.append(p)
    return Rs, ps


def collide_world_with_bodies(model: Model, R_body, p_body):
    """Run the static pair plan's narrowphase over the batch and concatenate
    into fixed buffers. Returns (Contacts, body_a, body_b) with per-slot
    body index tensors (nc,). A pair stored in the other order runs with its
    geoms in canonical order, so a slot's normal pushes body_a (the
    canonical geom A's body) away from body_b."""
    Rg, pg = geom_world_poses(model, R_body, p_body)
    batch = R_body.shape[:-3]
    dtype, dev = R_body.dtype, R_body.device
    pos_l, n_l, d_l, v_l, fr_l, re_l, ba_l, bb_l = [], [], [], [], [], [], [], []
    for (kind, fn, k, members) in _grouped_plan(model):
        ga_i = [ga for (ga, _, _) in members]
        gb_i = [gb for (_, gb, _) in members]
        Ra = torch.stack([Rg[g] for g in ga_i], dim=-3)
        pa = torch.stack([pg[g] for g in ga_i], dim=-2)
        Rb = torch.stack([Rg[g] for g in gb_i], dim=-3)
        pb = torch.stack([pg[g] for g in gb_i], dim=-2)
        sa = model.geom_size[ga_i].expand(*batch, len(members), 3)
        sb = model.geom_size[gb_i].expand(*batch, len(members), 3)
        pos, n, depth, valid = fn(Ra, pa, sa, Rb, pb, sb)  # (B, m, k, ...)
        pos_l.append(pos.reshape(*batch, -1, 3))
        n_l.append(n.reshape(*batch, -1, 3))
        d_l.append(depth.reshape(*batch, -1))
        v_l.append(valid.reshape(*batch, -1))
        # friction = min of the two geoms, restitution = product
        fr_l.append(torch.minimum(model.geom_friction[ga_i], model.geom_friction[gb_i])
                    .repeat_interleave(k))
        re_l.append((model.geom_restitution[ga_i] * model.geom_restitution[gb_i])
                    .repeat_interleave(k))
        ba_l += [model.geom_body[g] for g in ga_i for _ in range(k)]
        bb_l += [model.geom_body[g] for g in gb_i for _ in range(k)]
    if not pos_l:
        z3 = torch.zeros(*batch, 0, 3, dtype=dtype, device=dev)
        z = torch.zeros(*batch, 0, dtype=dtype, device=dev)
        e = torch.zeros(0, dtype=dtype, device=dev)
        zi = torch.zeros(0, dtype=torch.long, device=dev)
        return Contacts(z3, z3, z, z.bool(), e, e), zi, zi
    contacts = Contacts(
        pos=torch.cat(pos_l, dim=-2), normal=torch.cat(n_l, dim=-2), depth=torch.cat(d_l, dim=-1),
        valid=torch.cat(v_l, dim=-1), friction=torch.cat(fr_l), restitution=torch.cat(re_l))
    return (contacts, torch.tensor(ba_l, dtype=torch.long, device=dev),
            torch.tensor(bb_l, dtype=torch.long, device=dev))

