# Frozen copy of diffdart_tpu_torch/models/half_cheetah.py, the benchmark's plain reference; imports
# rewritten to portbench.reference. Later changes to the program do not reach it.
"""Planar half-cheetah: 9-DOF articulated chain with ground contact.

Counterpart of diffdart_tpu/models/half_cheetah.py (same bodies, geoms and
collision pairs); the main-path model of the port.

Topology:
  root: PLANAR (x/z translation + pitch about y)
  back leg: bthigh -> bshin -> bfoot   (3 hinges about y)
  front leg: fthigh -> fshin -> ffoot  (3 hinges about y)
Contacts: torso / both feet / both shins vs ground plane.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.dynamics.model import GeomType, JointType, Model, ModelBuilder


def _capsule_inertia(mass, r, hl):
    """Approximate capsule (axis z) inertia about COM."""
    L = 2 * hl
    ix = mass * (3 * r**2 + L**2) / 12.0
    iz = 0.5 * mass * r**2
    return np.diag([ix, ix, iz])


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def half_cheetah(dt=2e-3, dtype=torch.float32, device="cuda") -> Model:
    b = ModelBuilder(dt=dt, gravity=(0, 0, -9.81))
    ground = b.add_geom(-1, GeomType.PLANE, friction=0.9)

    # torso: planar root. axis=z (vertical slide), axis2=x (forward slide),
    # rotation about y = cross(z, x)
    torso = b.add_body(
        parent=-1, jtype=JointType.PLANAR, axis=(0, 0, 1), axis2=(1, 0, 0),
        mass=6.25, com=(0, 0, 0), inertia=np.diag([0.1, 0.9, 0.9]),
        damping=0.0, name="torso",
    )
    b.add_geom(torso, GeomType.CAPSULE, size=(0.046, 0.5, 0),
               rot=_rot_y(np.pi / 2), pos=(0, 0, 0), friction=0.9)

    def leg(prefix, sign):
        """sign=-1: back leg (attaches at -x), +1: front leg."""
        thigh = b.add_body(
            parent=torso, jtype=JointType.REVOLUTE, axis=(0, 1, 0),
            X_pos=(sign * 0.5, 0, 0), mass=1.5, com=(0, 0, -0.13),
            inertia=_capsule_inertia(1.5, 0.046, 0.133),
            damping=1.5, q_lo=-1.0, q_hi=0.9, name=f"{prefix}thigh",
        )
        b.add_geom(thigh, GeomType.CAPSULE, size=(0.046, 0.133, 0), pos=(0, 0, -0.13))
        shin = b.add_body(
            parent=thigh, jtype=JointType.REVOLUTE, axis=(0, 1, 0),
            X_pos=(0, 0, -0.26), mass=1.2, com=(0, 0, -0.12),
            inertia=_capsule_inertia(1.2, 0.046, 0.106),
            damping=1.0, q_lo=-1.2, q_hi=0.87, name=f"{prefix}shin",
        )
        sg = b.add_geom(shin, GeomType.CAPSULE, size=(0.046, 0.106, 0), pos=(0, 0, -0.12))
        foot = b.add_body(
            parent=shin, jtype=JointType.REVOLUTE, axis=(0, 1, 0),
            X_pos=(0, 0, -0.24), mass=0.9, com=(0.06 * sign, 0, -0.04),
            inertia=_capsule_inertia(0.9, 0.046, 0.07),
            damping=0.6, q_lo=-1.0, q_hi=0.9, name=f"{prefix}foot",
        )
        fg = b.add_geom(foot, GeomType.CAPSULE, size=(0.046, 0.07, 0),
                        rot=_rot_y(sign * 1.2), pos=(0.04 * sign, 0, -0.05), friction=0.9)
        return sg, fg

    bs, bf = leg("b", -1)
    fs, ff = leg("f", +1)

    # restrict collisions to the pairs that matter (ground vs torso/shins/feet)
    keep = {(min(ground, g), max(ground, g)) for g in [1, bs, bf, fs, ff]}
    m = b.finalize(dtype=dtype, device=device)
    pairs = tuple(p for p in m.col_pairs if p in keep)
    return m.replace(col_pairs=pairs)


def cheetah_init_q(model: Model) -> torch.Tensor:
    """Standing pose: root at z ~ 0.6, legs slightly bent."""
    q = np.zeros(model.nq)
    q[0] = 0.6  # root height (axis = z)
    q[3] = -0.1  # bthigh
    q[4] = 0.2  # bshin
    q[5] = -0.1  # bfoot
    q[6] = 0.1  # fthigh
    q[7] = -0.2  # fshin
    q[8] = 0.1  # ffoot
    return torch.as_tensor(q, dtype=model.dtype, device=model.device)
