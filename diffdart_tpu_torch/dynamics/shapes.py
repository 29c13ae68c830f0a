"""Mass properties from shapes: closed forms for every GeomType.

Counterpart of diffdart_tpu/dynamics/shapes.py, in numpy, used at build
and load time (io/urdf.py derives a link's mass, COM and inertia from its
collision geometry when the link has no <inertial>). Meshes use the exact
divergence-theorem integrals of io/mesh.py.
"""
from __future__ import annotations

import numpy as np

from diffdart_tpu_torch.dynamics.model import GeomType


def shape_mass_properties(gtype: int, size, verts=None, faces=None, density: float = 1000.0):
    """(mass, com (3,), inertia-about-com (3,3)) in the GEOM frame for a
    uniform-density shape. `size` follows Model.geom_size conventions.

    For CONVEX, pass `verts` (+ optional `faces`; a convex hull is built when
    faces are absent).
    """
    size = np.asarray(size, float)
    if gtype == GeomType.SPHERE:
        r = float(size[0])
        m = density * 4.0 / 3.0 * np.pi * r**3
        i = 2.0 / 5.0 * m * r * r
        return m, np.zeros(3), np.eye(3) * i
    if gtype == GeomType.BOX:
        hx, hy, hz = size
        m = density * 8.0 * hx * hy * hz
        I = m / 3.0 * np.diag([hy**2 + hz**2, hx**2 + hz**2, hx**2 + hy**2])
        return m, np.zeros(3), I
    if gtype == GeomType.CYLINDER:
        r, hl = float(size[0]), float(size[1])
        h = 2.0 * hl
        m = density * np.pi * r * r * h
        ixx = m * (3 * r * r + h * h) / 12.0
        return m, np.zeros(3), np.diag([ixx, ixx, 0.5 * m * r * r])
    if gtype == GeomType.CAPSULE:
        r, hl = float(size[0]), float(size[1])
        h = 2.0 * hl
        m_cyl = density * np.pi * r * r * h
        m_hemi = density * 2.0 / 3.0 * np.pi * r**3  # each hemisphere
        # cylinder part
        ixx_c = m_cyl * (3 * r * r + h * h) / 12.0
        izz_c = 0.5 * m_cyl * r * r
        # hemispheres: about their own COM then shifted to capsule center
        izz_h = 2.0 / 5.0 * m_hemi * r * r
        # hemisphere COM sits 3r/8 beyond the cylinder end
        d = hl + 3.0 * r / 8.0
        ixx_h = 2.0 / 5.0 * m_hemi * r * r - m_hemi * (3.0 * r / 8.0) ** 2 + m_hemi * d * d
        m = m_cyl + 2 * m_hemi
        ixx = ixx_c + 2 * ixx_h
        izz = izz_c + 2 * izz_h
        return m, np.zeros(3), np.diag([ixx, ixx, izz])
    if gtype == GeomType.ELLIPSOID:
        a, b, c = size
        m = density * 4.0 / 3.0 * np.pi * a * b * c
        I = m / 5.0 * np.diag([b * b + c * c, a * a + c * c, a * a + b * b])
        return m, np.zeros(3), I
    if gtype == GeomType.CONVEX:
        from diffdart_tpu_torch.io.mesh import mesh_volume_com_inertia

        if verts is None:
            raise ValueError("CONVEX needs verts")
        if faces is None:
            from scipy.spatial import ConvexHull

            hull = ConvexHull(np.asarray(verts, float))
            v = hull.points
            f = hull.simplices.astype(np.int32)
            # reorient each simplex outward (scipy does not guarantee winding)
            centroid = v[hull.vertices].mean(axis=0)
            tri = v[f]
            n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
            flip = np.einsum("ij,ij->i", n, tri[:, 0] - centroid) < 0
            f[flip] = f[flip][:, [0, 2, 1]]
            return mesh_volume_com_inertia(v, f, density)
        return mesh_volume_com_inertia(np.asarray(verts, float), np.asarray(faces, np.int32), density)
    if gtype == GeomType.PLANE:
        raise ValueError("a plane (static half-space) has no finite inertia")
    raise ValueError(f"unknown geom type {gtype}")


def body_mass_properties(geoms: list[dict], density: float = 1000.0):
    """Combine several geoms (dicts with type/size/R/p and optional verts)
    into one (mass, com, inertia-about-com) in the body frame, for a link
    that has no inertial tag."""
    total_m, moment, parts = 0.0, np.zeros(3), []
    for g in geoms:
        m, com_g, I_g = shape_mass_properties(
            g["type"], g["size"], verts=g.get("verts"), faces=g.get("faces"), density=density
        )
        R = np.asarray(g.get("R", np.eye(3)), float)
        p = np.asarray(g.get("p", np.zeros(3)), float)
        com_b = R @ com_g + p
        I_b = R @ I_g @ R.T
        parts.append((m, com_b, I_b))
        total_m += m
        moment += m * com_b
    if total_m <= 0:
        raise ValueError("no mass")
    com = moment / total_m
    I = np.zeros((3, 3))
    for m, c, Ig in parts:
        d = c - com
        I += Ig + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return total_m, com, I
