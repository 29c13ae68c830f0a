"""World collision: static pair list -> fixed-size contact buffers, batched.

Counterpart of diffdart_tpu/collision/collide.py. The pair list and the
slots per pair are decided when the model is built (model.col_pairs), so
every env has the same contact layout with a validity mask. Primitive
pairs are grouped by narrowphase function and each group runs as one
batched call over (env, member); each pair with a convex hull (a CONVEX
geom, or a box against one) runs on its own, on the model's padded hull
buffers. Slots are in group order, as in the JAX package.

Every pair type of the JAX package is dispatched: the primitive pairs of
collision/narrowphase.py (a cylinder against a capsule, box or cylinder
takes the capsule of its radius and length), the hull and ellipsoid pairs
of collision/convex.py. With `Model.contact_budget` K below the slot count,
select_contacts keeps each env's K deepest valid slots (ties in slot
order). With `Model.pair_budget` P, a primitive group of more than P pairs
first passes an AABB broadphase: each env keeps its P most-overlapping
pairs (ties in pair order) and only those run the narrowphase, so their
slots' body indices, friction and restitution are per env, (B, nc).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from diffdart_tpu_torch.collision import convex as CX
from diffdart_tpu_torch.collision import narrowphase as NP
from diffdart_tpu_torch.dynamics.model import GeomType, Model
from diffdart_tpu_torch.math.lie import tf_compose

_G = GeomType


def _swap(out):
    pos, n, d, v = out
    return pos, -n, d, v


def _cylinder_sphere(Ra, pa, sa, Rb, pb, sb):
    return _swap(NP.sphere_cylinder(Rb, pb, sb, Ra, pa, sa))


# (typeA, typeB) -> (fn, n_slots) in canonical order; a pair stored the other
# way round runs with its geoms swapped into this order
_DISPATCH = {
    (_G.SPHERE, _G.SPHERE): (NP.sphere_sphere, 1),
    (_G.SPHERE, _G.PLANE): (NP.sphere_plane, 1),
    (_G.SPHERE, _G.BOX): (NP.sphere_box, 1),
    (_G.SPHERE, _G.CAPSULE): (NP.sphere_capsule, 1),
    (_G.CAPSULE, _G.PLANE): (NP.capsule_plane, 2),
    (_G.CAPSULE, _G.CAPSULE): (NP.capsule_capsule, 1),
    (_G.CAPSULE, _G.BOX): (NP.capsule_box, 3),
    (_G.BOX, _G.PLANE): (NP.box_plane, 8),
    (_G.BOX, _G.BOX): (NP.box_box, 8),
    (_G.CYLINDER, _G.PLANE): (NP.cylinder_plane, 8),
    (_G.CYLINDER, _G.SPHERE): (_cylinder_sphere, 1),
    # a cylinder against a capsule, box or cylinder: the capsule of the same
    # radius and length
    (_G.CYLINDER, _G.CAPSULE): (NP.capsule_capsule, 1),
    (_G.CYLINDER, _G.BOX): (NP.capsule_box, 3),
    (_G.CYLINDER, _G.CYLINDER): (NP.capsule_capsule, 1),
    (_G.ELLIPSOID, _G.PLANE): (CX.ellipsoid_plane, 1),
    (_G.SPHERE, _G.ELLIPSOID): (CX.sphere_ellipsoid, 1),
}

# pairs that need hull buffers, canonical order -> slots (the function is
# built per pair by _make_hull_fn)
_DISPATCH_HULL_SLOTS = {
    (_G.CONVEX, _G.PLANE): 4,
    (_G.SPHERE, _G.CONVEX): 1,
    (_G.CAPSULE, _G.CONVEX): 3,
    (_G.CYLINDER, _G.CONVEX): 3,  # the capsule of the cylinder, as against a box
    (_G.BOX, _G.CONVEX): 4,
    (_G.CONVEX, _G.CONVEX): 4,
}


def _hull_args(model: Model, g: int):
    """(verts, face_n, face_b, vmask, fmask) of a CONVEX geom's padded hull,
    or of a box seen as a hull."""
    h = model.geom_hull[g]
    if h >= 0:
        dev = model.device
        vmask = torch.arange(model.hull_verts.shape[1], device=dev) < model.hull_vcounts[h]
        fmask = torch.arange(model.hull_face_n.shape[1], device=dev) < model.hull_fcounts[h]
        return model.hull_verts[h], model.hull_face_n[h], model.hull_face_b[h], vmask, fmask
    if model.geom_type[g] == _G.BOX:
        return CX.box_as_hull(model.geom_size[g], model.dtype)
    raise NotImplementedError(f"geom {g} has no hull representation")


def _make_hull_fn(model: Model, ta: int, tb: int, ga: int, gb: int):
    """fn(Ra, pa, Rb, pb) -> (pos, normal, depth, valid) for a hull pair in
    canonical order; the normal pushes geom ga away from geom gb."""
    if (ta, tb) == (_G.CONVEX, _G.PLANE):
        def fn(Ra, pa, Rb, pb):
            hv, _, _, vmask, _ = _hull_args(model, ga)
            return CX.convex_plane(Ra, pa, hv, vmask, Rb, pb)
    elif (ta, tb) == (_G.SPHERE, _G.CONVEX):
        def fn(Ra, pa, Rb, pb):
            hv, hn, hb, _, fmask = _hull_args(model, gb)
            return CX.sphere_convex(Ra, pa, model.geom_size[ga], Rb, pb, hv, hn, hb, fmask)
    elif (ta, tb) in ((_G.CAPSULE, _G.CONVEX), (_G.CYLINDER, _G.CONVEX)):
        def fn(Ra, pa, Rb, pb):
            hv, hn, hb, _, fmask = _hull_args(model, gb)
            return CX.capsule_convex(Ra, pa, model.geom_size[ga], Rb, pb, hv, hn, hb, fmask)
    elif (ta, tb) in ((_G.BOX, _G.CONVEX), (_G.CONVEX, _G.CONVEX)):
        def fn(Ra, pa, Rb, pb):
            return CX.convex_convex(Ra, pa, *_hull_args(model, ga), Rb, pb, *_hull_args(model, gb))
    else:
        raise NotImplementedError(f"no hull narrowphase for ({ta},{tb})")
    return fn


class Contacts(NamedTuple):
    """Fixed-size contact set, (B, nc, ...) per field. Per-slot body indices
    come from `contact_slots(model)`."""

    pos: torch.Tensor  # (B, nc, 3) world contact point
    normal: torch.Tensor  # (B, nc, 3) world normal, pushes body_a away from body_b
    depth: torch.Tensor  # (B, nc) penetration depth (> 0 = penetrating)
    valid: torch.Tensor  # (B, nc) bool
    friction: torch.Tensor  # (nc,); (B, nc) under a culling pair budget; (B, K) after a
    #                         contact budget's selection
    restitution: torch.Tensor  # likewise


def _pair_plan(model: Model):
    """Static narrowphase plan: per pair (kind, fn, slots, ga, gb, swapped)."""
    plan = []
    for (a, b) in model.col_pairs:
        ta, tb = model.geom_type[a], model.geom_type[b]
        if (ta, tb) in _DISPATCH:
            fn, k = _DISPATCH[(ta, tb)]
            plan.append(("prim", fn, k, a, b, False))
        elif (tb, ta) in _DISPATCH:
            fn, k = _DISPATCH[(tb, ta)]
            plan.append(("prim", fn, k, b, a, True))
        elif (ta, tb) in _DISPATCH_HULL_SLOTS:
            plan.append(("hull", _make_hull_fn(model, ta, tb, a, b), _DISPATCH_HULL_SLOTS[(ta, tb)],
                         a, b, False))
        elif (tb, ta) in _DISPATCH_HULL_SLOTS:
            plan.append(("hull", _make_hull_fn(model, tb, ta, b, a), _DISPATCH_HULL_SLOTS[(tb, ta)],
                         b, a, True))
        else:
            raise NotImplementedError(f"no narrowphase for geom types ({ta},{tb})")
    return plan


def _grouped_plan(model: Model):
    """The pair plan grouped by narrowphase function, in first-seen order:
    [(kind, fn, k, members)] with members [(ga, gb, swapped), ...]; a hull
    pair is a group of its own. Slot order is group order (contact_slots
    and collide_world_with_bodies both derive from this)."""
    groups: dict = {}
    order = []
    for (kind, fn, k, ga, gb, swapped) in _pair_plan(model):
        key = fn if kind == "prim" else ("hull", ga, gb)
        if key not in groups:
            groups[key] = (kind, fn, k, [])
            order.append(key)
        groups[key][3].append((ga, gb, swapped))
    return [groups[key] for key in order]


def _group_cap(model: Model, kind: str, members) -> int:
    """Pairs from this group entering narrowphase: all of them, or the AABB
    broadphase's budget (Model.pair_budget) for a larger primitive group."""
    n = len(members)
    if kind == "prim" and model.pair_budget and n > model.pair_budget:
        return int(model.pair_budget)
    return n


def max_contacts(model: Model) -> int:
    return sum(k * _group_cap(model, kind, members)
               for (kind, _, k, members) in _grouped_plan(model))


def _aabb_halfext(model: Model, g: int, Rg):
    """Half-extents (B, 3) of geom g's world AABB under its world rotation
    Rg (B, 3, 3): the broadphase's bound, conservative and cheap."""
    t = model.geom_type[g]
    size = model.geom_size[g]
    if t == _G.SPHERE:
        return size[0].expand(*Rg.shape[:-2], 3)
    if t in (_G.BOX, _G.ELLIPSOID):
        return (torch.abs(Rg) @ size.unsqueeze(-1)).squeeze(-1)
    if t in (_G.CAPSULE, _G.CYLINDER):
        return torch.abs(Rg[..., :, 2]) * size[1] + size[0]
    # a hull's pairs are never in a primitive group, so never culled
    raise NotImplementedError(f"no AABB for geom type {t}")


def _overlap_topk(model: Model, members, Ra, pa, Rb, pb, cap: int):
    """The broadphase: each env's `cap` most-overlapping pairs of a group,
    (B, cap) member indices, the most overlapping first and equal scores
    in pair order (a stable sort, as lax.top_k orders ties). A plane group
    scores the half-space overlap along the plane's normal (no AABB bounds
    a plane), other groups the smallest overlap of the two world AABBs.
    The score carries no gradient: only which pairs run is decided here."""
    ha = torch.stack([_aabb_halfext(model, ga, Ra[..., i, :, :])
                      for i, (ga, _, _) in enumerate(members)], dim=-2)  # (B, m, 3)
    if model.geom_type[members[0][1]] == _G.PLANE:
        nrm = Rb[..., :, 2]  # (B, m, 3)
        off = (nrm * pb).sum(-1)
        score = (ha * torch.abs(nrm)).sum(-1) - ((nrm * pa).sum(-1) - off)
    else:
        hb = torch.stack([_aabb_halfext(model, gb, Rb[..., i, :, :])
                          for i, (_, gb, _) in enumerate(members)], dim=-2)
        score = torch.amin(ha + hb - torch.abs(pa - pb), dim=-1)
    return torch.sort(score.detach(), dim=-1, descending=True, stable=True).indices[..., :cap]


def _per_env(x, idx):
    """x[..., idx] per env: static (n,) x indexed by (B, K) idx, or a
    per-env (B, n) x gathered along its last axis."""
    return x[idx] if x.dim() == 1 else torch.gather(x, -1, idx)


def effective_contacts(model: Model) -> int:
    """Contact slots entering the LCP: every narrowphase slot, or the
    contact budget when one is set below the slot count."""
    nc = max_contacts(model)
    if model.contact_budget and nc > model.contact_budget:
        return model.contact_budget
    return nc


def select_contacts(model: Model, contacts: Contacts, body_a=None, body_b=None):
    """The LCP's contact set and per-slot body indices. Without a budget:
    the contacts as they are, with the static body indices (nc,). With a
    budget K below the slot count: each env's K deepest valid slots
    (depth scored -inf where invalid), deepest first and equal scores in
    slot order (a stable sort, as lax.top_k orders ties); every field and
    body index then per env, (B, K, ...). Which slots are kept changes
    where contacts are made or broken, like the active set itself."""
    if body_a is None or body_b is None:
        sa, sb = contact_slots(model)
        dev = contacts.pos.device
        body_a = torch.tensor(sa, dtype=torch.long, device=dev)
        body_b = torch.tensor(sb, dtype=torch.long, device=dev)
    K = effective_contacts(model)
    if K == contacts.pos.shape[-2]:
        return contacts, body_a, body_b
    score = torch.where(contacts.valid, contacts.depth, torch.full_like(contacts.depth, -float("inf")))
    idx = torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :K]  # (B, K)
    idx3 = idx.unsqueeze(-1).expand(*idx.shape, 3)
    sel = Contacts(
        pos=torch.gather(contacts.pos, -2, idx3),
        normal=torch.gather(contacts.normal, -2, idx3),
        depth=torch.gather(contacts.depth, -1, idx),
        valid=torch.gather(contacts.valid, -1, idx),
        friction=_per_env(contacts.friction, idx),
        restitution=_per_env(contacts.restitution, idx),
    )
    return sel, _per_env(body_a, idx), _per_env(body_b, idx)


def contact_slots(model: Model):
    """Static per-slot metadata: (body_a, body_b) tuples of length
    max_contacts; body_a is the body pushed along +normal. Raises
    ValueError where the pair budget culls a group: its slots then map to
    pairs per env (collide_world_with_bodies gives those indices)."""
    if model.pair_budget and any(_group_cap(model, kind, members) < len(members)
                                 for (kind, _, _, members) in _grouped_plan(model)):
        raise ValueError("contact_slots: the slot-to-body mapping is per env under "
                         "Model.pair_budget; use collide_world_with_bodies")
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
    """Run the pair plan's narrowphase over the batch and concatenate into
    fixed buffers. Returns (Contacts, body_a, body_b) with per-slot body
    index tensors, (nc,), or (B, nc) where the pair budget culls a group
    (friction and restitution then (B, nc) too). A pair stored in the other
    order runs with its geoms in canonical order, so a slot's normal pushes
    body_a (the canonical geom A's body) away from body_b."""
    Rg, pg = geom_world_poses(model, R_body, p_body)
    batch = R_body.shape[:-3]
    dtype, dev = R_body.dtype, R_body.device
    pos_l, n_l, d_l, v_l, fr_l, re_l, ba_l, bb_l = [], [], [], [], [], [], [], []
    per_env = False
    for (kind, fn, k, members) in _grouped_plan(model):
        ga_i = [ga for (ga, _, _) in members]
        gb_i = [gb for (_, gb, _) in members]
        fr = torch.minimum(model.geom_friction[ga_i], model.geom_friction[gb_i])
        re = model.geom_restitution[ga_i] * model.geom_restitution[gb_i]
        ba = torch.tensor([model.geom_body[g] for g in ga_i], dtype=torch.long, device=dev)
        bb = torch.tensor([model.geom_body[g] for g in gb_i], dtype=torch.long, device=dev)
        if kind == "hull":  # one pair, its hull buffers closed over by fn
            (ga, gb, _), = members
            pos, n, depth, valid = fn(Rg[ga], pg[ga], Rg[gb], pg[gb])  # (B, k, ...)
        else:
            Ra = torch.stack([Rg[g] for g in ga_i], dim=-3)
            pa = torch.stack([pg[g] for g in ga_i], dim=-2)
            Rb = torch.stack([Rg[g] for g in gb_i], dim=-3)
            pb = torch.stack([pg[g] for g in gb_i], dim=-2)
            sa = model.geom_size[ga_i].expand(*batch, len(members), 3)
            sb = model.geom_size[gb_i].expand(*batch, len(members), 3)
            cap = _group_cap(model, kind, members)
            if cap < len(members):
                idx = _overlap_topk(model, members, Ra, pa, Rb, pb, cap)  # (B, cap)
                i3 = idx.unsqueeze(-1).expand(*idx.shape, 3)
                i33 = i3.unsqueeze(-1).expand(*idx.shape, 3, 3)
                Ra, Rb = torch.gather(Ra, -3, i33), torch.gather(Rb, -3, i33)
                pa, pb = torch.gather(pa, -2, i3), torch.gather(pb, -2, i3)
                sa, sb = torch.gather(sa, -2, i3), torch.gather(sb, -2, i3)
                ba, bb, fr, re = ba[idx], bb[idx], fr[idx], re[idx]  # (B, cap)
                per_env = True
            pos, n, depth, valid = fn(Ra, pa, sa, Rb, pb, sb)  # (B, m, k, ...)
        pos_l.append(pos.reshape(*batch, -1, 3))
        n_l.append(n.reshape(*batch, -1, 3))
        d_l.append(depth.reshape(*batch, -1))
        v_l.append(valid.reshape(*batch, -1))
        # friction = min of the two geoms, restitution = product
        fr_l.append(fr.repeat_interleave(k, dim=-1))
        re_l.append(re.repeat_interleave(k, dim=-1))
        ba_l.append(ba.repeat_interleave(k, dim=-1))
        bb_l.append(bb.repeat_interleave(k, dim=-1))
    if not pos_l:
        z3 = torch.zeros(*batch, 0, 3, dtype=dtype, device=dev)
        z = torch.zeros(*batch, 0, dtype=dtype, device=dev)
        e = torch.zeros(0, dtype=dtype, device=dev)
        zi = torch.zeros(0, dtype=torch.long, device=dev)
        return Contacts(z3, z3, z, z.bool(), e, e), zi, zi

    def cat(parts):
        if per_env:
            parts = [x.expand(*batch, x.shape[-1]) for x in parts]
        return torch.cat(parts, dim=-1)

    contacts = Contacts(
        pos=torch.cat(pos_l, dim=-2), normal=torch.cat(n_l, dim=-2), depth=torch.cat(d_l, dim=-1),
        valid=torch.cat(v_l, dim=-1), friction=cat(fr_l), restitution=cat(re_l))
    return contacts, cat(ba_l), cat(bb_l)


def collide_world(model: Model, R_body, p_body) -> Contacts:
    """The contacts of collide_world_with_bodies, without the body indices
    (contact_slots gives them for a model without a culling pair budget)."""
    return collide_world_with_bodies(model, R_body, p_body)[0]
