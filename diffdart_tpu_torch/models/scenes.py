"""Demo scenes. Counterpart of diffdart_tpu/models/scenes.py: the catapult
(BASELINE.json config 3) and the jump-worm."""
from __future__ import annotations

import numpy as np
import torch

from diffdart_tpu_torch.dynamics.model import GeomType, JointType, Model, ModelBuilder


def catapult(dt=2e-3, dtype=torch.float32, device="cuda") -> Model:
    """Catapult: a torque-driven two-link arm flings a free ball off its tip.
    Arm: 2 hinge links anchored at the origin (capsules); the ball, a free
    sphere, rests in the cradle (a shallow box) at the arm's tip; a ground
    plane for the landing."""
    b = ModelBuilder(dt=dt)
    b.add_geom(-1, GeomType.PLANE, friction=0.6)

    arm1 = b.add_body(
        parent=-1, jtype=JointType.REVOLUTE, axis=(0, 1, 0), X_pos=(0, 0, 0.1),
        mass=2.0, com=(0.25, 0, 0), inertia=np.diag([1e-3, 0.05, 0.05]),
        damping=0.5, q_lo=-1.2, q_hi=1.2, name="arm1",
    )
    b.add_geom(arm1, GeomType.CAPSULE, size=(0.04, 0.25, 0),
               rot=_rot_y(np.pi / 2), pos=(0.25, 0, 0), friction=0.6)
    arm2 = b.add_body(
        parent=arm1, jtype=JointType.REVOLUTE, axis=(0, 1, 0), X_pos=(0.5, 0, 0),
        mass=1.0, com=(0.2, 0, 0), inertia=np.diag([5e-4, 0.02, 0.02]),
        damping=0.3, q_lo=-1.5, q_hi=1.5, name="arm2",
    )
    b.add_geom(arm2, GeomType.CAPSULE, size=(0.03, 0.2, 0),
               rot=_rot_y(np.pi / 2), pos=(0.2, 0, 0), friction=0.6)
    # cradle: a shallow box at arm2's tip that the ball rests against
    b.add_geom(arm2, GeomType.BOX, size=(0.06, 0.06, 0.015), pos=(0.42, 0, 0.0), friction=0.6)

    ball = b.add_body(
        parent=-1, jtype=JointType.FREE, mass=0.3,
        inertia=np.eye(3) * (0.4 * 0.3 * 0.04**2), name="ball",
    )
    b.add_geom(ball, GeomType.SPHERE, size=(0.04, 0, 0), friction=0.6)
    return b.finalize(dtype=dtype, device=device)


def catapult_init_q(model: Model) -> torch.Tensor:
    """Arm cocked back, the ball resting on the cradle (placed by forward
    kinematics on the cradle box's top face, 1 mm above it)."""
    from diffdart_tpu_torch.collision.collide import geom_world_poses
    from diffdart_tpu_torch.dynamics.kinematics import fk

    q = np.zeros(model.nq)
    q[0] = -0.6  # arm1 cocked back
    q[1] = 0.4
    q[2] = 1.0  # ball quaternion w
    R, p = fk(model, torch.as_tensor(q, dtype=model.dtype, device=model.device).unsqueeze(0))
    _, pg = geom_world_poses(model, R, p)
    cradle = pg[3][0].detach().cpu().numpy()  # the cradle box on arm2
    ball_r = float(model.geom_size[4][0])
    q[6:9] = cradle + np.array([0.0, 0.0, 0.015 + ball_r + 1e-3])
    return torch.as_tensor(q, dtype=model.dtype, device=model.device)


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
