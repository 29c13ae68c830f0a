"""Demo scenes. Counterpart of diffdart_tpu/models/scenes.py; only the
jump-worm is ported so far (the catapult needs a FREE-joint ball and the
vmap stack's forward kinematics for its initial pose)."""
from __future__ import annotations

import numpy as np
import torch

from diffdart_tpu_torch.dynamics.model import GeomType, JointType, Model, ModelBuilder


def jump_worm(dt=2e-3, n_links=3, dtype=torch.float32, device="cuda") -> Model:
    """Planar worm on the ground: a PLANAR root segment followed by
    n_links - 1 limited hinges, one capsule per segment."""
    b = ModelBuilder(dt=dt)
    b.add_geom(-1, GeomType.PLANE, friction=1.0)
    root = b.add_body(
        parent=-1, jtype=JointType.PLANAR, axis=(0, 0, 1), axis2=(1, 0, 0),
        mass=0.5, com=(0.1, 0, 0), inertia=np.diag([1e-3, 2e-3, 2e-3]), name="seg0",
    )
    b.add_geom(root, GeomType.CAPSULE, size=(0.04, 0.1, 0),
               rot=_rot_y(np.pi / 2), pos=(0.1, 0, 0), friction=1.0)
    prev = root
    for i in range(1, n_links):
        prev = b.add_body(
            parent=prev, jtype=JointType.REVOLUTE, axis=(0, 1, 0), X_pos=(0.2, 0, 0),
            mass=0.5, com=(0.1, 0, 0), inertia=np.diag([1e-3, 2e-3, 2e-3]),
            damping=0.1, q_lo=-2.0, q_hi=2.0, name=f"seg{i}",
        )
        b.add_geom(prev, GeomType.CAPSULE, size=(0.04, 0.1, 0),
                   rot=_rot_y(np.pi / 2), pos=(0.1, 0, 0), friction=1.0)
    return b.finalize(dtype=dtype, device=device)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
