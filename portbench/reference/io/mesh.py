# Frozen copy of diffdart_tpu_torch/io/mesh.py, the benchmark's plain reference; imports
# rewritten to portbench.reference. Later changes to the program do not reach it.
"""The convex hull that a CONVEX geom carries (host side, at build time).

Counterpart of diffdart_tpu/io/mesh.py::convex_hull, in numpy and scipy
(scipy's ConvexHull, with farthest-point decimation above a vertex cap);
this copy keeps the hull alone, which model building (dynamics/model.py)
calls. The same scipy calls run in the same order as in the JAX package,
so a hull's vertices and planes are the same numbers.
"""
from __future__ import annotations

import numpy as np


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
