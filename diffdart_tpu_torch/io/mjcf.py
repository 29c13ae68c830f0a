"""MJCF scene import, with the `mujoco` package as the parser (host side,
run once at build time). Counterpart of diffdart_tpu/io/mjcf.py: a compiled
mujoco.MjModel becomes ModelBuilder calls. `mujoco` is imported inside the
loader, so the module imports without it; where it is missing, loading an
MJCF scene raises ImportError, and no other parser stands in.

Conventions mapped here:
  * a MuJoCo body may carry several joints acting at anchors away from the
    body origin; each becomes one body of the tree (extra joints get
    near-massless intermediate bodies), and the child frame is re-anchored
    at the joint position (inertial and geom data re-expressed accordingly);
  * free joints keep the body frame; hinge and slide axes are already in
    the child frame; ball joints use the quaternion parametrization.
"""
from __future__ import annotations

import numpy as np

from diffdart_tpu_torch.dynamics.model import GeomType, JointType, ModelBuilder

_GEOM_MAP = {
    0: GeomType.PLANE,  # mjGEOM_PLANE
    2: GeomType.SPHERE,
    3: GeomType.CAPSULE,
    4: GeomType.ELLIPSOID,
    5: GeomType.CYLINDER,
    6: GeomType.BOX,
}


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def load_mjcf_into_builder(builder: ModelBuilder, path_or_xml: str, default_friction=0.8):
    """Parse MJCF with mujoco and emit bodies/geoms into the builder.
    Returns the index of the first imported body."""
    import mujoco

    if path_or_xml.strip().startswith("<"):
        mj = mujoco.MjModel.from_xml_string(path_or_xml)
    else:
        mj = mujoco.MjModel.from_xml_path(path_or_xml)

    builder.gravity = tuple(mj.opt.gravity)
    builder.dt = float(mj.opt.timestep)

    body_idx = {0: -1}  # mujoco world body -> our world
    # our child frames sit at the joint anchor; children of an anchored body
    # must subtract the parent's anchor shift from their body_pos
    anchor_shift = {0: np.zeros(3)}
    first = None

    for b in range(1, mj.nbody):
        parent_mj = mj.body_parentid[b]
        R_pb = _quat_to_mat(mj.body_quat[b])
        p_pb = np.array(mj.body_pos[b]) - anchor_shift[parent_mj]
        mass = float(mj.body_mass[b])
        ipos = np.array(mj.body_ipos[b])
        iR = _quat_to_mat(mj.body_iquat[b])
        inertia = iR @ np.diag(mj.body_inertia[b]) @ iR.T

        jadr = mj.body_jntadr[b]
        jnum = mj.body_jntnum[b]
        parent_idx = body_idx[parent_mj]

        if jnum == 0:
            idx = builder.add_body(
                parent=parent_idx, jtype=JointType.WELD, X_rot=R_pb, X_pos=p_pb,
                mass=max(mass, 1e-9), com=ipos, inertia=np.maximum(inertia, 0) + np.eye(3) * 1e-12,
                name=_bname(mj, b),
            )
        else:
            # chain the body's joints; each child frame sits AT its joint
            # anchor (orientation = mujoco body frame). X_tree for joint k is
            # the offset from the previous anchor (or from the parent body).
            idx = parent_idx
            prev_anchor = np.zeros(3)
            for k in range(jnum):
                j = jadr + k
                jt = int(mj.jnt_type[j])
                anchor = np.array(mj.jnt_pos[j])
                axis = np.array(mj.jnt_axis[j])
                last = k == jnum - 1
                if k == 0:
                    X_rot, X_pos = R_pb, p_pb + R_pb @ anchor
                else:
                    X_rot, X_pos = np.eye(3), anchor - prev_anchor
                lo, hi = (-1e9, 1e9)
                if mj.jnt_limited[j]:
                    lo, hi = float(mj.jnt_range[j, 0]), float(mj.jnt_range[j, 1])
                dof = mj.jnt_dofadr[j]
                ours, ax = {
                    0: (JointType.FREE, (0, 0, 1)),
                    1: (JointType.BALL, (0, 0, 1)),
                    2: (JointType.PRISMATIC, tuple(axis)),
                    3: (JointType.REVOLUTE, tuple(axis)),
                }[jt]
                idx = builder.add_body(
                    parent=idx, jtype=ours, X_rot=X_rot, X_pos=X_pos, axis=ax,
                    mass=max(mass, 1e-9) if last else 1e-9,
                    com=(ipos - anchor) if last else np.zeros(3),
                    inertia=(np.maximum(inertia, 0) + np.eye(3) * 1e-12) if last else np.eye(3) * 1e-10,
                    damping=float(mj.dof_damping[dof]),
                    armature=float(mj.dof_armature[dof]),
                    q_lo=lo, q_hi=hi,
                    name=_bname(mj, b) if last else f"{_bname(mj, b)}_j{k}",
                )
                prev_anchor = anchor
        body_idx[b] = idx
        anchor_shift[b] = np.array(mj.jnt_pos[jadr + jnum - 1]) if jnum else np.zeros(3)
        if first is None:
            first = idx

        # geoms of this body, re-expressed relative to the anchored frame
        shift = np.array(mj.jnt_pos[jadr + jnum - 1]) if jnum else np.zeros(3)
        for g in range(mj.ngeom):
            if mj.geom_bodyid[g] != b:
                continue
            gt = int(mj.geom_type[g])
            if gt not in _GEOM_MAP:
                continue
            size = np.array(mj.geom_size[g])
            ours_t = _GEOM_MAP[gt]
            if ours_t == GeomType.CAPSULE:
                size = np.array([size[0], size[1], 0.0])
            elif ours_t == GeomType.CYLINDER:
                ours_t = GeomType.CAPSULE
                size = np.array([size[0], max(size[1] - size[0], 1e-4), 0.0])
            elif ours_t == GeomType.BOX:
                size = size.copy()
            builder.add_geom(
                body_idx[b] if mj.geom_bodyid[g] != 0 else -1,
                ours_t,
                size=size,
                rot=_quat_to_mat(mj.geom_quat[g]),
                pos=np.array(mj.geom_pos[g]) - shift,
                friction=float(mj.geom_friction[g, 0]),
            )

    # world geoms (body 0)
    for g in range(mj.ngeom):
        if mj.geom_bodyid[g] != 0:
            continue
        gt = int(mj.geom_type[g])
        if gt not in _GEOM_MAP:
            continue
        size = np.array(mj.geom_size[g])
        ours_t = _GEOM_MAP[gt]
        if ours_t == GeomType.CYLINDER:
            ours_t = GeomType.CAPSULE
            size = np.array([size[0], max(size[1] - size[0], 1e-4), 0.0])
        builder.add_geom(-1, ours_t, size=size, rot=_quat_to_mat(mj.geom_quat[g]),
                         pos=np.array(mj.geom_pos[g]), friction=float(mj.geom_friction[g, 0]))
    return first


def _bname(mj, b):
    import mujoco

    nm = mujoco.mj_id2name(mj, mujoco.mjtObj.mjOBJ_BODY, b)
    return nm or f"body{b}"
