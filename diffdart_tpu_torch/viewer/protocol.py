"""World-state wire protocol: model -> scene JSON, state -> frame JSON.

Counterpart of diffdart_tpu/viewer/protocol.py (the reference's
GUIWebsocketServer JSON protocol: a static scene description of geom
types, sizes and colours, then per-frame geom poses as position and wxyz
quaternion), consumed by the page of viewer/client.py. Positions take
any device; the poses of a trajectory are computed in one batch on the
model's device and copied to the host once.
"""
from __future__ import annotations

import numpy as np
import torch

from diffdart_tpu_torch.dynamics.kinematics import fk
from diffdart_tpu_torch.dynamics.model import GeomType, Model
from diffdart_tpu_torch.math.lie import mat_to_quat, tf_compose

_TYPE_NAMES = {
    GeomType.SPHERE: "sphere",
    GeomType.BOX: "box",
    GeomType.CAPSULE: "capsule",
    GeomType.PLANE: "plane",
    GeomType.CYLINDER: "cylinder",
    GeomType.ELLIPSOID: "ellipsoid",
    GeomType.CONVEX: "convex",
}

_PALETTE = ["#4c78a8", "#f58518", "#54a24b", "#e45756", "#72b7b2", "#eeca3b", "#b279a2"]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def scene_description(model: Model) -> dict:
    geoms = []
    for g in range(model.ngeom):
        body = model.geom_body[g]
        entry = dict(
            id=g,
            body=body,
            type=_TYPE_NAMES[model.geom_type[g]],
            size=_np(model.geom_size[g]).tolist(),
            color=_PALETTE[(body + 1) % len(_PALETTE)] if body >= 0 else "#999999",
        )
        if model.geom_type[g] == GeomType.CONVEX:
            h = model.geom_hull[g]
            nvert = model.hull_vcounts[h]
            entry["verts"] = _np(model.hull_verts[h][:nvert]).round(4).tolist()
        geoms.append(entry)
    return dict(kind="scene", nbody=model.nbody, geoms=geoms)


def _geom_poses(model: Model, qs):
    """World pose of every geom for positions qs (T, nq): positions
    (T, ngeom, 3) and wxyz quaternions (T, ngeom, 4), as host arrays."""
    qs = torch.as_tensor(qs).to(device=model.device, dtype=model.dtype)
    R, p = fk(model, qs)
    body = torch.tensor([max(b, 0) for b in model.geom_body], device=model.device)
    Rg, pg = tf_compose(R[:, body], p[:, body], model.geom_rot, model.geom_pos)
    world = torch.tensor([b < 0 for b in model.geom_body], device=model.device)
    Rg = torch.where(world[:, None, None], model.geom_rot, Rg)
    pg = torch.where(world[:, None], model.geom_pos, pg)
    return _np(pg), _np(mat_to_quat(Rg))


def _frame(pos, quat, t) -> dict:
    poses = [dict(pos=p.round(5).tolist(), quat=q.round(5).tolist()) for p, q in zip(pos, quat)]
    return dict(kind="frame", t=float(t), poses=poses)


def state_frame(model: Model, q, t=0.0) -> dict:
    """One frame: world pose (pos + wxyz quat) per GEOM, for q (nq,)."""
    pos, quat = _geom_poses(model, torch.as_tensor(q)[None])
    return _frame(pos[0], quat[0], t)


def trajectory_frames(model: Model, qs, dt=None, stride=1) -> list[dict]:
    """Frames for a (T, nq) trajectory (decimated by stride)."""
    dt = float(model.dt) if dt is None else dt
    qs = qs if torch.is_tensor(qs) else torch.as_tensor(np.asarray(qs))
    idx = list(range(0, len(qs), stride))
    pos, quat = _geom_poses(model, qs[idx])
    return [_frame(p, r, i * dt) for i, p, r in zip(idx, pos, quat)]
