"""Atlas-class humanoid: a 30-DOF skeleton loaded from URDF, with mesh feet.

Counterpart of diffdart_tpu/models/humanoid.py (BASELINE.json config 5:
"Atlas humanoid: ~30-DOF skeleton from URDF, full contact solve + per-step
Jacobians"). The asset is the JAX package's, read as a file:
diffdart_tpu/assets/atlas/atlas.urdf and its meshes/*.obj, which give the
pelvis, the torso and both feet convex-mesh collision geometry
(io/urdf.py -> io/mesh.py -> GeomType.CONVEX -> collision/convex.py).

DOF layout (nv = 30):
  free root (6) | back z,y,x (3) | neck y (1) |
  per leg: hip z,x,y + knee y + ankle y,x (6 x 2) |
  per arm: shoulder z,x + elbow y + wrist y (4 x 2)
Collision: the ground against each body geom (13 pairs, 33 contact slots);
self-collision is off.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from diffdart_tpu_torch.dynamics.model import GeomType, JointType, Model, ModelBuilder
from diffdart_tpu_torch.io.urdf import load_urdf_into_builder

ATLAS_URDF = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "diffdart_tpu", "assets", "atlas", "atlas.urdf")


def humanoid(dt=2e-3, dtype=torch.float32, device="cuda", urdf_path: str | None = None) -> Model:
    """The humanoid from its URDF asset (mesh collision), ground pairs only."""
    b = ModelBuilder(dt=dt)
    b.add_geom(-1, GeomType.PLANE, friction=0.9)
    load_urdf_into_builder(b, urdf_path or ATLAS_URDF, root_joint=JointType.FREE, friction=0.9)
    m = b.finalize(dtype=dtype, device=device)
    ground = 0
    keep = {(min(ground, g), max(ground, g)) for g in range(1, m.ngeom)}
    return m.replace(col_pairs=tuple(p for p in m.col_pairs if p in keep))


def humanoid_init_q(model: Model) -> torch.Tensor:
    """Standing pose, soles just touching the ground (root z = 0.986: hip
    offset 0.08 + thigh 0.42 + shin 0.41 + ankle to sole 0.075)."""
    q = np.zeros(model.nq)
    q[0] = 1.0  # quaternion w
    q[6] = 0.986
    return torch.as_tensor(q, dtype=model.dtype, device=model.device)
