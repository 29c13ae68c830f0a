"""Differentiable primitive narrowphase, batched over leading axes.

Counterpart of diffdart_tpu/collision/narrowphase.py, every pair: sphere
against sphere, plane, box, capsule and cylinder; capsule against plane,
capsule and box; box against plane and box; cylinder against plane. Every
pair returns a fixed number k of candidate contacts with a validity mask:
pos (..., k, 3), normal (..., k, 3), depth (..., k), valid (..., k), with
no branch on the data (torch.where instead), so the same operations run for
every env. The normal pushes geom A away from geom B; depth > 0 means
penetrating. Sizes: sphere (r, -, -); box half-extents; capsule (r,
half_len, -) and cylinder (r, half_height, -) along the geom z axis; a
plane's normal is its geom z axis. Where an index is picked (argmin,
argmax), the first of equal values wins, as in the JAX package.
"""
from __future__ import annotations

import torch

from diffdart_tpu_torch.math.lie import _mv


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _T(R):
    return R.transpose(-1, -2)


def _stack(outs):
    return tuple(torch.stack([o[i] for o in outs], dim=-2 if i < 2 else -1) for i in range(4))


def _gather(x, idx):
    """x (..., n) or (..., n, 3) at idx (..., k) along the slot axis."""
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx.unsqueeze(-1).expand(*idx.shape, x.shape[-1]))


def _take(x, i):
    """x (..., n) or (..., n, 3) at the index i (...) along the slot axis."""
    return _gather(x, i.unsqueeze(-1)).squeeze(-2 if x.dim() > i.dim() + 1 else -1)


def _col(R, i):
    """Column i (...) of R (..., 3, 3)."""
    return torch.gather(R, -1, i[..., None, None].expand(*i.shape, 3, 1)).squeeze(-1)


def _onehot(i, like):
    """(..., 3) bool: True at index i (...)."""
    return torch.arange(3, device=like.device) == i.unsqueeze(-1)


def _radius(r, like):
    """Size triples (r, 0, 0) for a sphere of radius r (...)."""
    z = torch.zeros_like(r)
    return torch.stack([r, z, z], dim=-1).to(like.dtype)


def _sign(cond, dtype):
    """+1 where cond, else -1, in `dtype`."""
    return torch.where(cond, 1.0, -1.0).to(dtype)


def sphere_sphere(Ra, pa, sa, Rb, pb, sb):
    ra, rb = sa[..., 0], sb[..., 0]
    d = pa - pb
    dist2 = torch.sum(d * d, dim=-1)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-18))
    n = d / dist.unsqueeze(-1)
    depth = ra + rb - dist
    pos = pb + n * (rb - 0.5 * depth).unsqueeze(-1)
    return _stack([(pos, n, depth, depth > 0)])


def sphere_plane(Ra, pa, sa, Rb, pb, sb):
    """A = sphere, B = plane (normal = B's z axis)."""
    r = sa[..., 0]
    n = Rb[..., :, 2]
    depth = r - _dot(pa - pb, n)
    pos = pa - n * (r - 0.5 * depth).unsqueeze(-1)
    return _stack([(pos, n, depth, depth > 0)])


def sphere_box(Ra, pa, sa, Rb, pb, sb):
    """A = sphere, B = box: the centre outside (clamp to the box) and inside
    (push out through the nearest face), without a branch."""
    r = sa[..., 0]
    half = sb
    c = _mv(_T(Rb), pa - pb)  # sphere centre in the box frame
    clamped = torch.clamp(c, -half, half)
    delta = c - clamped
    dist2 = torch.sum(delta * delta, dim=-1)
    outside = dist2 > 1e-16
    dist = torch.sqrt(torch.clamp(dist2, min=1e-18))
    n_out = delta / dist.unsqueeze(-1)  # box frame, pushes the sphere away
    face_d = half - torch.abs(c)  # distance to each face (>= 0 inside)
    ax = torch.argmin(face_d, dim=-1)
    sign = _sign(_take(c, ax) >= 0, c.dtype)
    n_in = torch.where(_onehot(ax, c), sign.unsqueeze(-1), torch.zeros_like(c))
    fd = _take(face_d, ax)
    depth = torch.where(outside, r - dist, r + fd)
    n_local = torch.where(outside.unsqueeze(-1), n_out, n_in)
    surf_local = torch.where(outside.unsqueeze(-1), clamped, c + n_in * fd.unsqueeze(-1))
    n = _mv(Rb, n_local)
    pos = _mv(Rb, surf_local) + pb
    return _stack([(pos, n, depth, depth > 0)])


def sphere_capsule(Ra, pa, sa, Rb, pb, sb):
    """A = sphere, B = capsule (axis = B's z, half length sb[1], radius sb[0])."""
    rc, hl = sb[..., 0], sb[..., 1]
    axis = Rb[..., :, 2]
    t = torch.clamp(_dot(pa - pb, axis), -hl, hl)
    closest = pb + axis * t.unsqueeze(-1)
    return sphere_sphere(Ra, pa, sa, Rb, closest, _radius(rc, sa))


def sphere_cylinder(Ra, pa, sa, Rb, pb, sb):
    """A = sphere, B = cylinder (axis = B's z, radius sb[0], half-height
    sb[1]): the flat-capped cylinder, its wall, cap and rim edge all from
    one clamp for a centre outside, the nearer of wall and cap for a centre
    inside; safe on the axis."""
    r = sa[..., 0]
    rc, h = sb[..., 0], sb[..., 1]
    c = _mv(_T(Rb), pa - pb)  # sphere centre in the cylinder frame
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    zero, one = torch.zeros_like(cx), torch.ones_like(cx)
    ez = torch.stack([zero, zero, one], dim=-1)
    rho2 = cx * cx + cy * cy
    rho = torch.sqrt(torch.clamp(rho2, min=1e-18))
    on_axis = rho2 < 1e-16
    e_r = torch.where(on_axis.unsqueeze(-1), torch.stack([one, zero, zero], dim=-1),
                      torch.stack([cx, cy, zero], dim=-1) / rho.unsqueeze(-1))
    # closest point of the solid cylinder to c; the actual xy is scaled
    # (exactly 0 on the axis), not e_r
    s_xy = torch.clamp(rc / rho, max=1.0)
    q = torch.stack([cx * s_xy, cy * s_xy, zero], dim=-1) + ez * torch.clamp(cz, -h, h).unsqueeze(-1)
    delta = c - q
    dist2 = torch.sum(delta * delta, dim=-1)
    outside = dist2 > 1e-16
    dist = torch.sqrt(torch.clamp(dist2, min=1e-18))
    n_out = delta / dist.unsqueeze(-1)
    # inside: out through the lateral wall or the nearer cap, whichever is closer
    d_lat = rc - rho
    d_cap = h - torch.abs(cz)
    lat = d_lat <= d_cap
    sign = _sign(cz >= 0, c.dtype)
    n_in = torch.where(lat.unsqueeze(-1), e_r, ez * sign.unsqueeze(-1))
    depth_in = r + torch.where(lat, d_lat, d_cap)
    surf_in = torch.where(lat.unsqueeze(-1), e_r * rc.unsqueeze(-1) + ez * cz.unsqueeze(-1),
                          torch.stack([cx, cy, zero], dim=-1) + ez * (sign * h).unsqueeze(-1))
    n_local = torch.where(outside.unsqueeze(-1), n_out, n_in)
    depth = torch.where(outside, r - dist, depth_in)
    surf_local = torch.where(outside.unsqueeze(-1), q, surf_in)
    n = _mv(Rb, n_local)
    pos = _mv(Rb, surf_local) + pb
    return _stack([(pos, n, depth, depth > 0)])


def capsule_plane(Ra, pa, sa, Rb, pb, sb):
    """A = capsule, B = plane: 2 candidate contacts at the end spheres."""
    r, hl = sa[..., 0], sa[..., 1]
    axis = Ra[..., :, 2]
    n = Rb[..., :, 2]
    outs = []
    for s in (-1.0, 1.0):
        c = pa + axis * (s * hl).unsqueeze(-1)
        depth = r - _dot(c - pb, n)
        pos = c - n * (r - 0.5 * depth).unsqueeze(-1)
        outs.append((pos, n, depth, depth > 0))
    return _stack(outs)


def capsule_capsule(Ra, pa, sa, Rb, pb, sb):
    """The closest points of the two core segments -> one sphere-sphere
    contact (segment-segment closest points after Ericson, Real-Time
    Collision Detection)."""
    ra, ha = sa[..., 0], sa[..., 1]
    rb, hb = sb[..., 0], sb[..., 1]
    ua, ub = Ra[..., :, 2], Rb[..., :, 2]
    d = pa - pb
    a_dot_b = _dot(ua, ub)
    denom = 1.0 - a_dot_b * a_dot_b
    par = denom < 1e-12
    ta_free = (-_dot(d, ua) + a_dot_b * _dot(d, ub)) / torch.where(par, torch.ones_like(denom), denom)
    ta = torch.clamp(torch.where(par, torch.zeros_like(ta_free), ta_free), -ha, ha)
    tb = torch.clamp(_dot(d + ua * ta.unsqueeze(-1), ub), -hb, hb)
    ta = torch.clamp(-_dot(d, ua) + tb * a_dot_b, -ha, ha)
    ca = pa + ua * ta.unsqueeze(-1)
    cb = pb + ub * tb.unsqueeze(-1)
    return sphere_sphere(Ra, ca, _radius(ra, sa), Rb, cb, _radius(rb, sa))


def _seg_box_t(p0, u, hl, half, iters=40):
    """t in [-hl, hl] minimizing the distance from the segment point
    p0 + t u to the origin-centred box with half-extents `half` (box
    frame). The squared distance to a convex set is convex in t, so a
    fixed-count ternary search is exact to (2/3)^iters * 2 hl."""
    def dist2(t):
        c = p0 + t.unsqueeze(-1) * u
        d = c - torch.clamp(c, -half, half)
        return torch.sum(d * d, dim=-1)

    lo, hi = -hl * torch.ones_like(hl), hl * torch.ones_like(hl)
    for _ in range(iters):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        shrink_lo = dist2(m1) > dist2(m2)
        lo, hi = torch.where(shrink_lo, m1, lo), torch.where(shrink_lo, hi, m2)
    return 0.5 * (lo + hi)


def capsule_box(Ra, pa, sa, Rb, pb, sb):
    """Capsule A vs box B, 3 candidates: the two end spheres and the core
    segment's point closest to the box (ternary search on the convex
    squared distance, exact across face, edge and vertex regions), each
    resolved as an exact sphere-box contact."""
    r, hl = sa[..., 0], sa[..., 1]
    axis = Ra[..., :, 2]
    p0_l = _mv(_T(Rb), pa - pb)
    u_l = _mv(_T(Rb), axis)
    t_star = _seg_box_t(p0_l, u_l, hl, sb)
    outs = []
    for t in (-hl, t_star, hl):
        c = pa + axis * t.unsqueeze(-1)
        o = sphere_box(Ra, c, _radius(r, sa), Rb, pb, sb)
        outs.append(tuple(x[..., 0, :] if i < 2 else x[..., 0] for i, x in enumerate(o)))
    return _stack(outs)


def cylinder_plane(Ra, pa, sa, Rb, pb, sb):
    """A = cylinder (axis z, radius sa[0], half-height sa[1]), B = plane.
    8 rim candidates, the rim direction steepest down the plane and its
    orthogonal pair on both caps: upright (a 4-point ring), lying (2
    points) and tilted (1 point) alike."""
    r, h = sa[..., 0], sa[..., 1]
    axis = Ra[..., :, 2]
    n = Rb[..., :, 2]
    # rim direction steepest down the plane: -n projected onto the cap plane
    d_raw = -n + _dot(n, axis).unsqueeze(-1) * axis
    d2 = torch.sum(d_raw * d_raw, dim=-1)
    ok = d2 > 1e-12
    scale = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, d2, torch.ones_like(d2))),
                        torch.zeros_like(d2))
    d_hat = d_raw * scale.unsqueeze(-1)
    # the flat case (axis parallel to n) takes the geom's x axis
    d_hat = torch.where(ok.unsqueeze(-1), d_hat, Ra[..., :, 0])
    t_hat = torch.linalg.cross(axis, d_hat, dim=-1)
    outs = []
    for s_cap in (-1.0, 1.0):
        c = pa + axis * (s_cap * h).unsqueeze(-1)
        for dvec in (d_hat, -d_hat, t_hat, -t_hat):
            p = c + r.unsqueeze(-1) * dvec
            depth = -_dot(p - pb, n)
            outs.append((p + 0.5 * depth.unsqueeze(-1) * n, n, depth, depth > 0))
    return _stack(outs)


def box_plane(Ra, pa, sa, Rb, pb, sb):
    """A = box, B = plane: all 8 corners are candidate contacts."""
    n = Rb[..., :, 2]
    outs = []
    for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
            for sz in (-1.0, 1.0):
                corner_local = sa * torch.tensor([sx, sy, sz], dtype=sa.dtype, device=sa.device)
                c = _mv(Ra, corner_local) + pa
                depth = -_dot(c - pb, n)
                outs.append((c + 0.5 * depth.unsqueeze(-1) * n, n, depth, depth > 0))
    return _stack(outs)


def _box_face_contacts(Rr, pr, sr, Ri, pi, si, sep3):
    """Face-contact hypothesis of box_box with the reference box r: the
    incident box i's face most anti-parallel to the reference face normal,
    its 4 corners clamped to the reference face. Returns pos (..., 4, 3),
    the reference normal (..., 3) pointing toward the incident box, and
    each corner's depth below the reference face (..., 4)."""
    axf = torch.argmax(sep3, dim=-1)
    dr = _mv(_T(Rr), pi - pr)
    sign = _sign(_take(dr, axf) >= 0, sr.dtype)
    ef = _onehot(axf, sr)
    n_ref = torch.where(ef, sign.unsqueeze(-1), torch.zeros_like(sr))
    n_world = _mv(Rr, n_ref)
    n_inc = _mv(_T(Ri), -n_world)
    axi = torch.argmax(torch.abs(n_inc), dim=-1)
    sign_i = _sign(_take(n_inc, axi) >= 0, si.dtype)
    ei, e1, e2 = (_onehot((axi + k) % 3, si) for k in (0, 1, 2))
    face = (sign_i * _take(si, axi)).unsqueeze(-1)
    corners = []
    for s1 in (-1.0, 1.0):
        for s2 in (-1.0, 1.0):
            cl = torch.where(ei, face, torch.where(e1, s1 * si, torch.where(e2, s2 * si,
                                                                            torch.zeros_like(si))))
            corners.append(_mv(Ri, cl) + pi)
    corners = torch.stack(corners, dim=-2)  # (..., 4, 3) world
    # clip against the reference face's 4 side planes by clamping in its
    # tangent plane (reference frame)
    cr = (corners - pr.unsqueeze(-2)) @ Rr
    side = (_onehot((axf + 1) % 3, sr) | _onehot((axf + 2) % 3, sr)).unsqueeze(-2)
    srx = sr.unsqueeze(-2)
    clip = torch.where(side, torch.clamp(cr, -srx, srx), cr)
    depth = _take(sr, axf).unsqueeze(-1) - sign.unsqueeze(-1) * torch.gather(
        cr, -1, axf[..., None, None].expand(*axf.shape, 4, 1)).squeeze(-1)
    pos_world = clip @ _T(Rr) + pr.unsqueeze(-2)
    return pos_world, n_world, depth


def box_box(Ra, pa, sa, Rb, pb, sb):
    """SAT box-box with face clipping (the ODE-style box-box test), 8
    candidate contacts: both face-contact hypotheses (A's face, B's face)
    and the best edge-edge one, the slots chosen by the SAT axis of least
    penetration, faces preferred over edges by a 5% margin."""
    d = pb - pa
    C = _T(Ra) @ Rb  # columns: B's axes in A's frame
    absC = torch.abs(C) + 1e-6  # the epsilon avoids SAT degeneracy at alignment
    dA = _mv(_T(Ra), d)  # centre offset in A's frame
    dB = _mv(_T(Rb), -d)
    sep_A = torch.abs(dA) - (sa + _mv(absC, sb))  # negative: overlapping
    sep_B = torch.abs(dB) - (sb + _mv(_T(absC), sa))

    # edge-edge axes a_i x b_j (9)
    seps, axes, oks = [], [], []
    for i in range(3):
        for j in range(3):
            axis_w = torch.linalg.cross(Ra[..., :, i], Rb[..., :, j], dim=-1)
            # parallel edges give a zero cross product: guard n2 before the sqrt
            n2 = torch.sum(axis_w * axis_w, dim=-1)
            ok = n2 > 1e-12
            axis_w = axis_w * torch.where(
                ok, 1.0 / torch.sqrt(torch.where(ok, n2, torch.ones_like(n2))),
                torch.zeros_like(n2)).unsqueeze(-1)
            ra_proj = torch.sum(sa * torch.abs(_mv(_T(Ra), axis_w)), dim=-1)
            rb_proj = torch.sum(sb * torch.abs(_mv(_T(Rb), axis_w)), dim=-1)
            sep = torch.abs(_dot(d, axis_w)) - (ra_proj + rb_proj)
            seps.append(torch.where(ok, sep, torch.full_like(sep, -1e3)))
            axes.append(axis_w)
            oks.append(ok)
    edge_seps = torch.stack(seps, dim=-1)
    edge_axes = torch.stack(axes, dim=-2)
    edge_oks = torch.stack(oks, dim=-1)

    # a positive separation on any axis: disjoint
    disjoint = torch.cat([sep_A, sep_B, edge_seps], dim=-1).amax(-1) > 0
    face_seps = torch.cat([sep_A, sep_B], dim=-1)
    face_best = torch.argmax(face_seps, dim=-1)  # the least negative separation
    edge_pen = torch.where(edge_oks, edge_seps, torch.full_like(edge_seps, -1e9))
    edge_best = torch.argmax(edge_pen, dim=-1)
    best_edge_pen = _take(edge_pen, edge_best)
    use_edge = best_edge_pen * 1.05 > _take(face_seps, face_best) + 1e-9

    # face contacts; our convention: the normal pushes geom A away from B
    posA, nA_, depA = _box_face_contacts(Ra, pa, sa, Rb, pb, sb, sep_A)  # n points A -> B
    posB, nB_, depB = _box_face_contacts(Rb, pb, sb, Ra, pa, sa, sep_B)  # n points B -> A
    use_A = (_take(sep_A, torch.argmax(sep_A, dim=-1))
             >= _take(sep_B, torch.argmax(sep_B, dim=-1)))
    pos_face = torch.where(use_A[..., None, None], posA, posB)
    n_face = torch.where(use_A.unsqueeze(-1), -nA_, nB_).unsqueeze(-2).expand_as(pos_face)
    dep_face = torch.where(use_A.unsqueeze(-1), depA, depB)

    # edge contact
    ei, ej = edge_best // 3, edge_best % 3
    axis_w = torch.gather(edge_axes, -2, edge_best[..., None, None].expand(*edge_best.shape, 1, 3)
                          ).squeeze(-2)
    axis_w = axis_w * _sign(_dot(axis_w, d) <= 0, d.dtype).unsqueeze(-1)  # from B to A
    # support points: A's corner furthest along -axis, B's along +axis
    signs_a = torch.where(_onehot(ei, sa), torch.zeros_like(sa), -torch.sign(_mv(_T(Ra), axis_w)))
    pa_edge = pa + _mv(Ra, signs_a * sa)
    signs_b = torch.where(_onehot(ej, sb), torch.zeros_like(sb), torch.sign(_mv(_T(Rb), axis_w)))
    pb_edge = pb + _mv(Rb, signs_b * sb)
    # closest points of the two edge lines (along A's axis ei and B's axis ej)
    ua, ub = _col(Ra, ei), _col(Rb, ej)
    dd = pa_edge - pb_edge
    adb = _dot(ua, ub)
    den = 1.0 - adb * adb
    ta = (-_dot(dd, ua) + adb * _dot(dd, ub)) / torch.where(den < 1e-12, torch.ones_like(den), den)
    tb = _dot(dd + ua * ta.unsqueeze(-1), ub)
    ca = pa_edge + ua * ta.unsqueeze(-1)
    cb = pb_edge + ub * tb.unsqueeze(-1)
    pos_edge = 0.5 * (ca + cb)
    dep_edge = -best_edge_pen

    pos8 = torch.cat([pos_face, pos_edge.unsqueeze(-2).expand_as(pos_face)], dim=-2)
    n8 = torch.cat([n_face, axis_w.unsqueeze(-2).expand_as(pos_face)], dim=-2)
    dep8 = torch.cat([dep_face, dep_edge.unsqueeze(-1),
                      torch.full((*dep_edge.shape, 3), -1.0, dtype=d.dtype, device=d.device)], dim=-1)
    slot_is_face = torch.arange(8, device=d.device) < 4
    pen = dep8 > 0
    valid = torch.where(use_edge.unsqueeze(-1), ~slot_is_face & pen, slot_is_face & pen)
    return pos8, n8, dep8, valid & ~disjoint.unsqueeze(-1)
