"""Triangle-mesh loading and geometry derivation (host side, at build time).

Counterpart of diffdart_tpu/io/mesh.py, in numpy and scipy: STL (binary
and ASCII) and OBJ loaders, the convex hull that a CONVEX geom carries
(scipy's ConvexHull, with farthest-point decimation above a vertex cap),
exact mass properties of a closed mesh, a best-fit primitive, procedural
box and cylinder meshes, and OBJ/STL writers. The same scipy calls run in
the same order as in the JAX package, so a hull's vertices and planes are
the same numbers. Nothing here touches a tensor: model building
(dynamics/model.py) reduces each mesh to fixed-size padded buffers once.
"""
from __future__ import annotations

import os
import struct as _struct

import numpy as np


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

def load_mesh(path: str, scale=(1.0, 1.0, 1.0)) -> tuple[np.ndarray, np.ndarray]:
    """Load a triangle mesh -> (verts (V,3) f64, faces (F,3) int32).

    Dispatches on extension: .stl (binary or ASCII) and .obj.
    `scale` is applied per-axis (URDF <mesh scale="...">).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".stl":
        v, f = load_stl(path)
    elif ext == ".obj":
        v, f = load_obj(path)
    else:
        raise ValueError(f"unsupported mesh format: {path!r} (use .stl or .obj)")
    return v * np.asarray(scale, np.float64), f


def load_stl(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Binary or ASCII STL -> deduplicated (verts, faces)."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        # could still be binary with a 'solid' header: check for 'facet'
        with open(path, "rb") as f:
            blob = f.read(1024)
        if b"facet" in blob:
            return _load_stl_ascii(path)
    return _load_stl_binary(path)


def _load_stl_binary(path: str) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        f.seek(80)
        (n_tri,) = _struct.unpack("<I", f.read(4))
        data = np.fromfile(f, dtype=np.uint8, count=n_tri * 50)
    if data.size != n_tri * 50:
        raise ValueError(f"truncated binary STL: {path}")
    rec = data.reshape(n_tri, 50)
    tri = rec[:, 12:48].copy().view("<f4").reshape(n_tri, 3, 3).astype(np.float64)
    return _dedup_triangles(tri)


def _load_stl_ascii(path: str) -> tuple[np.ndarray, np.ndarray]:
    tris, cur = [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if t[:1] == ["vertex"]:
                cur.append([float(t[1]), float(t[2]), float(t[3])])
                if len(cur) == 3:
                    tris.append(cur)
                    cur = []
    if not tris:
        raise ValueError(f"no triangles in ASCII STL: {path}")
    return _dedup_triangles(np.asarray(tris, np.float64))


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Wavefront OBJ (v / f records; polygons fan-triangulated)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "f":
                idx = [int(w.split("/")[0]) for w in t[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not verts:
        raise ValueError(f"no vertices in OBJ: {path}")
    return np.asarray(verts, np.float64), np.asarray(faces, np.int32)


def _dedup_triangles(tri: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(T,3,3) triangle soup -> indexed (verts, faces), merging exact dups."""
    flat = tri.reshape(-1, 3)
    verts, inv = np.unique(flat, axis=0, return_inverse=True)
    return verts, inv.reshape(-1, 3).astype(np.int32)


# ---------------------------------------------------------------------------
# derived geometry
# ---------------------------------------------------------------------------

def mesh_bounds(verts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return verts.min(axis=0), verts.max(axis=0)


def convex_hull(verts: np.ndarray, max_verts: int | None = None):
    """Convex hull of a point cloud -> (hull_verts (H,3), face_normals (F,3),
    face_offsets (F,)) with planes satisfying n·x <= b for hull points.

    If max_verts is given and the hull is larger, the hull is decimated by
    greedy farthest-point selection on the hull vertices and re-hulled —
    a conservative simplification adequate for collision (the narrowphase
    consumes fixed-size buffers).
    """
    from scipy.spatial import ConvexHull

    hull = ConvexHull(verts)
    hv = verts[hull.vertices]
    if max_verts is not None and hv.shape[0] > max_verts:
        hv = _farthest_point_subset(hv, max_verts)
        hull = ConvexHull(hv)
        hv = hv[hull.vertices]
        hull = ConvexHull(hv)
    # scipy equations: n·x + d <= 0  ->  n·x <= -d
    eqs = hull.equations
    normals = eqs[:, :3]
    offsets = -eqs[:, 3]
    return hv, normals, offsets


def _farthest_point_subset(pts: np.ndarray, k: int) -> np.ndarray:
    """Greedy farthest-point sampling, seeded with the lowest-index extreme."""
    sel = [int(np.argmax(pts[:, 0]))]
    d = np.linalg.norm(pts - pts[sel[0]], axis=1)
    for _ in range(k - 1):
        nxt = int(np.argmax(d))
        sel.append(nxt)
        d = np.minimum(d, np.linalg.norm(pts - pts[nxt], axis=1))
    return pts[sel]


def mesh_volume_com_inertia(verts: np.ndarray, faces: np.ndarray, density: float = 1000.0):
    """Exact (volume, COM, inertia-about-COM) of a closed triangle mesh by
    the divergence theorem over signed tetrahedra.

    Returns (mass, com (3,), I (3,3)) for uniform `density` [kg/m^3].
    """
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    # signed tetra volumes against the origin
    cross = np.cross(v1, v2)
    d6v = np.einsum("ij,ij->i", v0, cross)  # 6 * signed volume
    vol = d6v.sum() / 6.0
    if abs(vol) < 1e-12:
        raise ValueError("mesh is degenerate or not closed (zero volume)")
    # centroid: per-tet centroid (v0+v1+v2+0)/4 weighted by signed volume
    com = (d6v[:, None] * (v0 + v1 + v2)).sum(axis=0) / (24.0 * vol)

    # inertia: covariance integrals per signed tetra via the canonical-simplex
    # map; canon[k,l] = ∫_canonical-tet λ_k λ_l = (1+δ_kl)/20 (with the origin
    # vertex contributing zero)
    canon = (np.ones((3, 3)) + np.eye(3)) / 20.0
    V = np.stack([v0, v1, v2], axis=1)  # (T, vertex, coord)
    C = np.einsum("t,kl,tka,tlb->ab", d6v / 6.0, canon, V, V)
    mass = density * abs(vol)
    C = C * density * np.sign(vol)
    # shift to COM: C_com = C - m * com comT
    C = C - mass * np.outer(com, com)
    I = np.trace(C) * np.eye(3) - C
    return mass, com, I


def fit_primitive(verts: np.ndarray) -> dict:
    """Best-fit collision primitive for a vertex cloud: tries sphere / box /
    capsule on the PCA frame and returns the one with the smallest volume
    overshoot. Used when the caller wants a primitive instead of the hull
    (URDF loading keeps the hull by default).

    Returns {'type': 'sphere'|'box'|'capsule', 'size': (3,), 'rot': (3,3),
    'pos': (3,)} in the mesh frame.
    """
    c = verts.mean(axis=0)
    X = verts - c
    _, _, Vt = np.linalg.svd(X, full_matrices=False)
    R = Vt.T  # columns = principal axes
    if np.linalg.det(R) < 0:
        R[:, 2] = -R[:, 2]
    Y = X @ R  # PCA-frame coords
    lo, hi = Y.min(axis=0), Y.max(axis=0)
    half = (hi - lo) / 2.0
    mid = (hi + lo) / 2.0
    pos = c + R @ mid

    r_sphere = float(np.linalg.norm(Y - mid, axis=1).max())
    vol_sphere = 4.0 / 3.0 * np.pi * r_sphere**3
    vol_box = float(8.0 * half.prod())
    # capsule along the longest principal axis
    ax = int(np.argmax(half))
    perp = [i for i in range(3) if i != ax]
    r_cap = float(np.linalg.norm((Y - mid)[:, perp], axis=1).max())
    hl = max(float(half[ax]) - r_cap, 1e-9)
    vol_cap = np.pi * r_cap**2 * (2 * hl) + 4.0 / 3.0 * np.pi * r_cap**3

    best = min(
        [("sphere", vol_sphere), ("box", vol_box), ("capsule", vol_cap)],
        key=lambda kv: kv[1],
    )[0]
    if best == "sphere":
        return {"type": "sphere", "size": np.array([r_sphere, 0, 0]), "rot": np.eye(3), "pos": pos}
    if best == "box":
        return {"type": "box", "size": half, "rot": R, "pos": pos}
    # capsule: size = (radius, half_length); orient local z along the axis
    z = R[:, ax]
    x = R[:, perp[0]]
    y = np.cross(z, x)
    Rc = np.stack([x, y, z], axis=1)
    return {"type": "capsule", "size": np.array([r_cap, hl, 0]), "rot": Rc, "pos": pos}


# ---------------------------------------------------------------------------
# procedural meshes (asset generation + tests)
# ---------------------------------------------------------------------------

def box_mesh(half_extents) -> tuple[np.ndarray, np.ndarray]:
    """Closed box mesh (8 verts, 12 tris) with outward winding."""
    hx, hy, hz = np.asarray(half_extents, np.float64)
    v = np.array(
        [[sx * hx, sy * hy, sz * hz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    )
    f = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 6, 7], [4, 7, 5],  # +x
            [0, 4, 5], [0, 5, 1],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        np.int32,
    )
    return v, f


def cylinder_mesh(radius: float, half_length: float, n: int = 12) -> tuple[np.ndarray, np.ndarray]:
    """Closed prism approximation of a z-aligned cylinder (2n+2 verts)."""
    ang = 2 * np.pi * np.arange(n) / n
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=1)
    bot = np.concatenate([ring, np.full((n, 1), -half_length)], axis=1)
    top = np.concatenate([ring, np.full((n, 1), half_length)], axis=1)
    cb, ct = np.array([[0, 0, -half_length]]), np.array([[0, 0, half_length]])
    verts = np.concatenate([bot, top, cb, ct])
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces += [[i, j, n + i], [j, n + j, n + i]]  # side
        faces += [[2 * n, j, i], [2 * n + 1, n + i, n + j]]  # caps
    return verts, np.asarray(faces, np.int32)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("# generated by diffdart_tpu_torch.io.mesh\n")
        for v in verts:
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        for tri in faces:
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


def save_stl(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Binary STL."""
    tri = verts[faces]  # (T, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    with open(path, "wb") as f:
        f.write(b"\x00" * 80)
        f.write(_struct.pack("<I", len(faces)))
        rec = np.zeros((len(faces), 50), np.uint8)
        payload = np.concatenate([n[:, None, :], tri], axis=1).astype("<f4")  # (T,4,3)
        rec[:, :48] = payload.reshape(len(faces), 12).view(np.uint8)
        rec.tofile(f)
