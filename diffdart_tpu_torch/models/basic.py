"""Canonical test models, built programmatically. Counterpart of
diffdart_tpu/models/basic.py; so far `cartpole` (BASELINE config 1) and
`cube_drop` (BASELINE config 2). The others are ROADMAP Queue 1 item 1."""
from __future__ import annotations

import numpy as np
import torch

from diffdart_tpu_torch.dynamics.model import GeomType, JointType, Model, ModelBuilder


def cartpole(dt=1e-3, cart_mass=1.0, pole_mass=0.3, pole_length=0.6, dtype=torch.float32,
             device="cuda") -> Model:
    """Cart (prismatic along x) + pole (revolute about y), pole up at
    q = (0, 0)."""
    b = ModelBuilder(dt=dt)
    cart = b.add_body(
        parent=-1, jtype=JointType.PRISMATIC, axis=(1, 0, 0),
        mass=cart_mass, com=(0, 0, 0), inertia=np.eye(3) * 1e-3, name="cart",
    )
    b.add_body(
        parent=cart, jtype=JointType.REVOLUTE, axis=(0, 1, 0),
        mass=pole_mass, com=(0, 0, pole_length / 2),
        inertia=np.diag([pole_mass * pole_length**2 / 12, pole_mass * pole_length**2 / 12, 1e-5]),
        name="pole",
    )
    return b.finalize(dtype=dtype, device=device)


def cube_drop(dt=1e-3, half=0.1, mass=1.0, friction=0.8, restitution=0.0, n_cubes=1,
              dtype=torch.float32, device="cuda") -> Model:
    """Free cube(s) over a ground plane: 8 box corners per cube against the
    plane, a redundant contact set."""
    b = ModelBuilder(dt=dt)
    b.add_geom(-1, GeomType.PLANE, size=(0, 0, 0), friction=friction)
    for i in range(n_cubes):
        body = b.add_body(
            parent=-1, jtype=JointType.FREE, mass=mass, com=(0, 0, 0),
            inertia=np.eye(3) * (mass * (2 * half) ** 2 / 6), name=f"cube{i}",
        )
        b.add_geom(body, GeomType.BOX, size=(half, half, half),
                   friction=friction, restitution=restitution)
    return b.finalize(dtype=dtype, device=device)
