"""Canonical test models, built programmatically. Counterpart of
diffdart_tpu/models/basic.py: `pendulum`, `double_pendulum`, `chain` (a
serial chain of any joint types), `cartpole` (BASELINE config 1),
`projectile`, `cube_drop` (BASELINE config 2) and `capsule_lying`. Each
takes the dtype and device of its tensors (default float32 on CUDA)."""
from __future__ import annotations

import numpy as np
import torch

from diffdart_tpu_torch.dynamics.model import GeomType, JointType, Model, ModelBuilder


def _rod_inertia(mass, length, radius=0.02):
    """Inertia of a rod along +x about its COM."""
    ix = 0.5 * mass * radius**2
    iyz = mass * (3 * radius**2 + length**2) / 12.0
    return np.diag([ix, iyz, iyz])


def pendulum(dt=1e-3, length=0.5, mass=1.0, damping=0.0, dtype=torch.float32,
             device="cuda") -> Model:
    """One rod on a revolute joint about y."""
    b = ModelBuilder(dt=dt)
    b.add_body(parent=-1, jtype=JointType.REVOLUTE, axis=(0.0, 1.0, 0.0), mass=mass,
               com=(length / 2, 0.0, 0.0), inertia=_rod_inertia(mass, length), damping=damping,
               name="link0")
    return b.finalize(dtype=dtype, device=device)


def double_pendulum(dt=1e-3, length=0.5, mass=1.0, dtype=torch.float32, device="cuda") -> Model:
    """Two rods on revolute joints about y."""
    b = ModelBuilder(dt=dt)
    i0 = b.add_body(parent=-1, jtype=JointType.REVOLUTE, axis=(0, 1, 0), mass=mass,
                    com=(length / 2, 0, 0), inertia=_rod_inertia(mass, length), name="link0")
    b.add_body(parent=i0, jtype=JointType.REVOLUTE, axis=(0, 1, 0), X_pos=(length, 0, 0),
               mass=mass, com=(length / 2, 0, 0), inertia=_rod_inertia(mass, length), name="link1")
    return b.finalize(dtype=dtype, device=device)


def chain(n=5, jtypes=None, dt=1e-3, length=0.3, mass=0.7, dtype=torch.float32,
          device="cuda") -> Model:
    """Serial chain of n rods, joint types `jtypes` (default all revolute),
    axes cycling through y, z, x."""
    if jtypes is None:
        jtypes = [JointType.REVOLUTE] * n
    b = ModelBuilder(dt=dt)
    prev = -1
    axes = [(0, 1, 0), (0, 0, 1), (1, 0, 0)]
    for i in range(n):
        prev = b.add_body(parent=prev, jtype=jtypes[i], axis=axes[i % 3],
                          X_pos=(length, 0, 0) if i > 0 else (0, 0, 0), mass=mass,
                          com=(length / 2, 0.05 * (i % 2), 0), inertia=_rod_inertia(mass, length),
                          name=f"link{i}")
    return b.finalize(dtype=dtype, device=device)


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


def projectile(dt=1e-3, mass=1.0, dtype=torch.float32, device="cuda") -> Model:
    """One free body, no geometry."""
    b = ModelBuilder(dt=dt)
    b.add_body(parent=-1, jtype=JointType.FREE, mass=mass, com=(0, 0, 0),
               inertia=np.eye(3) * 0.01, name="ball")
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


def capsule_lying(dt=2e-3, radius=0.05, half_len=0.2, mass=1.0, friction=0.8,
                  dtype=torch.float32, device="cuda") -> Model:
    """Free capsule lying flat on the ground (axis horizontal): both caps
    touch the plane at once, so the contact normal rows are nearly linearly
    dependent (the case the pivot refinement of ops/lcp_pivot.py is for)."""
    b = ModelBuilder(dt=dt)
    body = b.add_body(parent=-1, jtype=JointType.FREE, mass=mass,
                      inertia=np.diag([0.02, 0.02, 0.005]) * mass, name="capsule")
    # capsule axis along x (geom frame z -> world x)
    rot = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])
    b.add_geom(body, GeomType.CAPSULE, size=(radius, half_len, 0.0), rot=rot, friction=friction)
    b.add_geom(-1, GeomType.PLANE, friction=friction)
    return b.finalize(dtype=dtype, device=device)
