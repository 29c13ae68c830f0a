"""Convex-hull and ellipsoid narrowphase, batched over leading axes.

Counterpart of diffdart_tpu/collision/convex.py. A mesh is reduced when the
model is built to a padded vertex and face-plane buffer (io/mesh.py,
dynamics/model.py), and every pair function here is fixed-size and
branchless: masks instead of control flow, so each returns k candidate
contacts with a validity mask, like collision/narrowphase.py: pos (..., k,
3), normal (..., k, 3), depth (..., k), valid (..., k). The normal pushes
geom A away from geom B; depth > 0 means penetrating.

Hull representation (local frame):
  verts (V, 3), padded by repeating vertex 0 (a duplicate changes no
  support or extremum); vmask (V,) True for real vertices;
  face_n (F, 3), face_b (F,): outward planes n.x <= b, padded by repeating
  face 0; fmask (F,) True for real faces.
The pose arguments (R (..., 3, 3), p (..., 3)) carry the batch; the hull
buffers and sizes are the model's, unbatched.

Contact regimes (only depth > 0 matters; the LCP masks the rest):
  * hull vs plane: exact, the k deepest vertices below the plane;
  * point or sphere vs hull: exact while the centre is inside (the largest
    signed face distance); a shallow outside contact takes the nearest
    face, exact over face interiors, conservative near edges;
  * hull vs hull: SAT over both hulls' face normals with a k-deepest vertex
    manifold.
Selections among equal scores keep the lower index first (a stable sort),
as the JAX package's argsort does.
"""
from __future__ import annotations

import torch

from diffdart_tpu_torch.collision.narrowphase import _T, _dot, _gather, _stack, _take
from diffdart_tpu_torch.math.lie import _mv

_BIG = 1e9


def _world_verts(R, p, verts):
    return verts @ _T(R) + p.unsqueeze(-2)


def _topk_contacts(pos, depth, valid, k):
    """The k deepest valid candidates as fixed slots, ties in index order."""
    score = torch.where(valid, depth, torch.full_like(depth, -_BIG))
    idx = torch.sort(-score, dim=-1, stable=True).indices[..., :k]
    return _gather(pos, idx), _gather(depth, idx), _gather(valid, idx)


def box_as_hull(size, dtype):
    """An 8-vertex, 6-face hull of a box with half-extents `size` (3,), so
    that every hull pair function doubles as the exact box variant."""
    dev = size.device
    sign = torch.tensor(
        [[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0) for z in (-1.0, 1.0)],
        dtype=dtype, device=dev)
    s = torch.stack([size[..., 0], size[..., 1], size[..., 2]], dim=-1)
    verts = sign * s.unsqueeze(-2)
    eye = torch.eye(3, dtype=dtype, device=dev)
    face_n = torch.cat([eye, -eye])
    face_b = torch.cat([s, s], dim=-1)
    vmask = torch.ones(8, dtype=torch.bool, device=dev)
    fmask = torch.ones(6, dtype=torch.bool, device=dev)
    return verts, face_n, face_b, vmask, fmask


# ---------------------------------------------------------------------------
# pair functions
# ---------------------------------------------------------------------------


def convex_plane(Ra, pa, verts, vmask, Rb, pb, k=4):
    """A = hull, B = plane (normal = B's z axis). Exact: every hull vertex
    below the plane is a candidate; the k deepest become contact slots."""
    n = Rb[..., :, 2]
    w = _world_verts(Ra, pa, verts)  # (..., V, 3)
    depth = _dot(pb, n).unsqueeze(-1) - _mv(w, n)  # > 0 below the plane
    valid = (depth > 0) & vmask
    pos, depth, valid = _topk_contacts(w, depth, valid, k)
    return pos, n.unsqueeze(-2).expand_as(pos), depth, valid


def point_hull_depth(c_local, verts, face_n, face_b, fmask):
    """Signed penetration of a point into a hull (local frame): depth > 0
    inside (distance to the nearest face plane), < 0 outside (the nearest
    face, exact over face interiors). Returns (depth (...), normal (..., 3))."""
    sd = _mv(face_n, c_local) - face_b  # per-face signed distance, < 0 inside
    sd = torch.where(fmask, sd, torch.full_like(sd, -_BIG))
    i = torch.argmax(sd, dim=-1)
    return -_take(sd, i), _take(face_n.expand(*sd.shape, 3), i)


def sphere_convex(Ra, pa, sa, Rb, pb, verts, face_n, face_b, fmask):
    """A = sphere, B = hull."""
    r = sa[..., 0]
    c = _mv(_T(Rb), pa - pb)  # sphere centre in the hull frame
    depth_c, n_local = point_hull_depth(c, verts, face_n, face_b, fmask)
    depth = depth_c + r
    n = _mv(Rb, n_local)  # pushes the sphere out of the hull
    pos = pa - n * (r - 0.5 * depth).unsqueeze(-1)
    return _stack([(pos, n, depth, depth > 0)])


def capsule_convex(Ra, pa, sa, Rb, pb, verts, face_n, face_b, fmask):
    """A = capsule (radius sa[0], half-length sa[1], axis = A's z), B =
    hull: three sample spheres along the axis (the ends and the middle)."""
    r, hl = sa[..., 0], sa[..., 1]
    axis = Ra[..., :, 2]
    outs = []
    for t in (-1.0, 0.0, 1.0):
        center = pa + axis * (hl * t).unsqueeze(-1)
        c = _mv(_T(Rb), center - pb)
        depth_c, n_local = point_hull_depth(c, verts, face_n, face_b, fmask)
        depth = depth_c + r
        n = _mv(Rb, n_local)
        pos = center - n * (r - 0.5 * depth).unsqueeze(-1)
        outs.append((pos, n, depth, depth > 0))
    return _stack(outs)


def convex_convex(Ra, pa, va, na_, ba, vmask_a, fmask_a,
                  Rb, pb, vb, nb_, bb, vmask_b, fmask_b, k=4):
    """A, B = hulls. SAT over the face normals of both hulls: the
    penetration along a face axis of B is its offset less the least
    projection of A's vertices, and symmetrically; the axis of least
    penetration gives the depth and the normal (pushing A away from B).
    Manifold: the k deepest of A's vertices inside B and B's inside A."""
    wa = _world_verts(Ra, pa, va)  # (..., VA, 3)
    wb = _world_verts(Rb, pb, vb)  # (..., VB, 3)
    nB_w = nb_ @ _T(Rb)  # (..., FB, 3): B's face planes in the world, n.x <= b
    bB_w = bb + _mv(nB_w, pb)
    nA_w = na_ @ _T(Ra)
    bA_w = ba + _mv(nA_w, pa)
    big = torch.full((), _BIG, dtype=wa.dtype, device=wa.device)

    # penetration along B's axes: b_i less the least n_i.x over A's vertices
    minA_on_B = torch.where(vmask_a, nB_w @ _T(wa), big).amin(-1)  # (..., FB)
    pen_B = torch.where(fmask_b, bB_w - minA_on_B, big)
    minB_on_A = torch.where(vmask_b, nA_w @ _T(wb), big).amin(-1)  # (..., FA)
    pen_A = torch.where(fmask_a, bA_w - minB_on_A, big)

    iB = torch.argmin(pen_B, dim=-1)
    iA = torch.argmin(pen_A, dim=-1)
    pB, pA = _take(pen_B, iB), _take(pen_A, iA)
    use_B = pB <= pA
    depth_sat = torch.where(use_B, pB, pA)
    # B's normals point out of B (good); A's point out of A, so flip
    n_sat = torch.where(use_B.unsqueeze(-1), _take(nB_w, iB), -_take(nA_w, iA))
    overlapping = depth_sat > 0

    # manifold: A's vertices inside B (depth = least clearance to B's faces)
    # and B's inside A, each contact at the vertex
    inB = torch.where(fmask_b, bB_w.unsqueeze(-2) - wa @ _T(nB_w), big)  # (..., VA, FB)
    depth_a = inB.amin(-1)
    val_a = (depth_a > 0) & vmask_a & overlapping.unsqueeze(-1)
    inA = torch.where(fmask_a, bA_w.unsqueeze(-2) - wb @ _T(nA_w), big)  # (..., VB, FA)
    depth_b = inA.amin(-1)
    val_b = (depth_b > 0) & vmask_b & overlapping.unsqueeze(-1)

    pos = torch.cat([wa, wb], dim=-2)
    depth = torch.cat([depth_a, depth_b], dim=-1)
    valid = torch.cat([val_a, val_b], dim=-1)
    pos, depth, valid = _topk_contacts(pos, depth, valid, k)
    return pos, n_sat.unsqueeze(-2).expand_as(pos), depth, valid


# ---------------------------------------------------------------------------
# ellipsoid pairs (support-mapped)
# ---------------------------------------------------------------------------


def ellipsoid_plane(Ra, pa, sa, Rb, pb, sb):
    """A = ellipsoid (radii sa), B = plane. Exact: the ellipsoid's support
    point along -n is p - (E^2 n_l) / |E n_l| (E = diag(radii), local)."""
    n = Rb[..., :, 2]
    nl = _mv(_T(Ra), n)
    e2 = sa * sa
    denom = torch.sqrt(torch.clamp(torch.sum(e2 * nl * nl, dim=-1), min=1e-18))
    sup_l = -(e2 * nl) / denom.unsqueeze(-1)  # deepest point, local
    sup = pa + _mv(Ra, sup_l)
    depth = _dot(pb - sup, n)
    pos = sup + 0.5 * depth.unsqueeze(-1) * n
    return _stack([(pos, n, depth, depth > 0)])


def sphere_ellipsoid(Ra, pa, sa, Rb, pb, sb, iters=12):
    """A = sphere, B = ellipsoid. The closest point on the ellipsoid to the
    sphere's centre, by Newton on the one Lagrange multiplier t of
    x_i = c_i e_i^2 / (e_i^2 + t): exact for outside centres, monotone; a
    centre deep inside falls back to the push-out of the largest axis."""
    r = sa[..., 0]
    e2 = sb * sb
    c = _mv(_T(Rb), pa - pb)  # sphere centre in the ellipsoid frame

    def phi(t):
        return torch.sum(e2 * c * c / (e2 + t.unsqueeze(-1)) ** 2, dim=-1) - 1.0

    def dphi(t):
        return -2.0 * torch.sum(e2 * c * c / (e2 + t.unsqueeze(-1)) ** 3, dim=-1)

    inside = torch.sum(c * c / torch.clamp(e2, min=1e-18), dim=-1) < 1.0
    t = torch.zeros_like(c[..., 0])
    floor = -0.9 * e2.amin(-1)
    for _ in range(iters):
        d = dphi(t)
        step = phi(t) / torch.where(torch.abs(d) > 1e-18, d, torch.full_like(d, -1e-18))
        # keep t on the valid branch (t > -min e2 for outside points)
        t = torch.maximum(t - step, floor)
    x = e2 * c / (e2 + t.unsqueeze(-1))  # closest surface point (local)
    n_l = x / torch.clamp(e2, min=1e-18)
    n_l = n_l / torch.clamp(torch.linalg.vector_norm(n_l, dim=-1, keepdim=True), min=1e-12)
    dist = torch.linalg.vector_norm(c - x, dim=-1) * torch.where(inside, -1.0, 1.0)
    depth = r - dist
    n = _mv(Rb, n_l)  # pushes the sphere away from the ellipsoid
    pos = pa - n * (r - 0.5 * depth).unsqueeze(-1)
    return _stack([(pos, n, depth, depth > 0)])
