"""DART .skel scene parser -> ModelBuilder (host side, run once at build
time). Counterpart of diffdart_tpu/io/skel.py, on xml.etree and numpy.

The subset that DART's test scenes use: <world> physics (gravity, time
step), skeletons with body nodes (world-frame <transformation>, inertia,
box / sphere / capsule / cylinder collision shapes) and joints (free, ball,
revolute, prismatic, universal, planar, translational, weld) with
joint-frame offsets.

SKEL conventions handled here:
  * a body's <transformation> is its initial WORLD placement;
  * a joint's <transformation> is the joint frame in the CHILD body frame
    (T_cj). The Model pins the child frame to the joint frame, so each
    body's inertial and geom data are re-expressed in the joint frame and
    the fixed parent->joint transform comes from the initial world poses:
        X_tree = (X_w_parent)^-1 . X_w_child . T_cj,  at zero joint position.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from diffdart_tpu_torch.dynamics.model import GeomType, JointType

_JOINT_MAP = {
    "free": JointType.FREE,
    "ball": JointType.BALL,
    "revolute": JointType.REVOLUTE,
    "prismatic": JointType.PRISMATIC,
    "universal": JointType.UNIVERSAL,
    "planar": JointType.PLANAR,
    "translational": JointType.TRANSLATIONAL,
    "weld": JointType.WELD,
    "euler": JointType.EULER,
    "screw": JointType.SCREW,
}


def _floats(s, n=None):
    v = np.array([float(x) for x in s.split()], dtype=float)
    return v


def _euler_xyz_to_mat(rpy):
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _tf(el):
    """<transformation>x y z r p y</transformation> -> (R, p)."""
    if el is None:
        return np.eye(3), np.zeros(3)
    v = _floats(el.text)
    return _euler_xyz_to_mat(v[3:6]), v[:3]


def _inv(R, p):
    return R.T, -R.T @ p


def _mul(Ra, pa, Rb, pb):
    return Ra @ Rb, Ra @ pb + pa


def _parse_shape(geom_el):
    if geom_el.find("box") is not None:
        size = _floats(geom_el.find("box").find("size").text) / 2.0
        return GeomType.BOX, size
    if geom_el.find("sphere") is not None:
        r = float(geom_el.find("sphere").find("radius").text)
        return GeomType.SPHERE, np.array([r, 0, 0])
    if geom_el.find("capsule") is not None:
        c = geom_el.find("capsule")
        r = float(c.find("radius").text)
        h = float(c.find("height").text)
        return GeomType.CAPSULE, np.array([r, h / 2.0, 0])
    if geom_el.find("cylinder") is not None:
        c = geom_el.find("cylinder")
        r = float(c.find("radius").text)
        h = float(c.find("height").text)
        return GeomType.CAPSULE, np.array([r, max(h / 2.0 - r, 1e-4), 0])
    if geom_el.find("plane") is not None:
        return GeomType.PLANE, np.zeros(3)
    return None, None


def load_skel_into_builder(builder, path: str, skeleton_name: str | None = None,
                           friction: float = 0.8, restitution: float = 0.0):
    """Load the first (or named) skeleton of a .skel world into the builder.
    Also applies the world's gravity/time step to the builder when present."""
    root = ET.parse(path).getroot() if os.path.exists(path) else ET.fromstring(path)
    world = root if root.tag == "world" else root.find("world")
    if world is None:
        raise ValueError("no <world> element in .skel file")
    physics = world.find("physics")
    if physics is not None:
        g = physics.find("gravity")
        if g is not None:
            builder.gravity = tuple(_floats(g.text))
        ts = physics.find("time_step")
        if ts is not None:
            builder.dt = float(ts.text)

    skels = world.findall("skeleton")
    if skeleton_name is not None:
        skels = [s for s in skels if s.get("name") == skeleton_name]
    if not skels:
        raise ValueError("no skeleton found")
    first_root = None
    for sk in skels:
        idx = _load_one(builder, sk, friction, restitution)
        first_root = idx if first_root is None else first_root
    return first_root


def _load_one(builder, sk, friction, restitution):
    # body world placements
    bodies = {}
    for b in sk.findall("body"):
        R_wb, p_wb = _tf(b.find("transformation"))
        inertia_el = b.find("inertia")
        mass, com, moment = 1.0, np.zeros(3), np.eye(3) * 1e-3
        if inertia_el is not None:
            m_el = inertia_el.find("mass")
            if m_el is not None:
                mass = float(m_el.text)
            off = inertia_el.find("offset")
            if off is not None:
                com = _floats(off.text)
            mom = inertia_el.find("moment_of_inertia")
            if mom is not None:
                def g(tag, d=0.0):
                    e = mom.find(tag)
                    return float(e.text) if e is not None else d
                moment = np.array(
                    [
                        [g("ixx", 1e-3), g("ixy"), g("ixz")],
                        [g("ixy"), g("iyy", 1e-3), g("iyz")],
                        [g("ixz"), g("iyz"), g("izz", 1e-3)],
                    ]
                )
        geoms = []
        for col in b.findall("collision_shape"):
            R_bs, p_bs = _tf(col.find("transformation"))
            gtype, size = _parse_shape(col.find("geometry"))
            if gtype is not None:
                geoms.append((gtype, size, R_bs, p_bs))
        bodies[b.get("name")] = dict(R=R_wb, p=p_wb, mass=mass, com=com,
                                     moment=moment, geoms=geoms)

    joints = []
    for j in sk.findall("joint"):
        parent = j.find("parent").text.strip()
        child = j.find("child").text.strip()
        jtype = _JOINT_MAP[j.get("type")]
        T_cj = _tf(j.find("transformation"))  # joint frame in child body frame
        axis_el = j.find("axis")
        axis = _floats(axis_el.find("xyz").text) if axis_el is not None and axis_el.find("xyz") is not None else np.array([0.0, 0, 1])
        axis2_el = j.find("axis2")
        axis2 = _floats(axis2_el.find("xyz").text) if axis2_el is not None and axis2_el.find("xyz") is not None else np.array([0.0, 1, 0])
        lo, hi = -1e9, 1e9
        if axis_el is not None and axis_el.find("limit") is not None:
            lim = axis_el.find("limit")
            if lim.find("lower") is not None:
                lo = float(lim.find("lower").text)
            if lim.find("upper") is not None:
                hi = float(lim.find("upper").text)
        damping = 0.0
        if axis_el is not None and axis_el.find("dynamics") is not None:
            d = axis_el.find("dynamics").find("damping")
            if d is not None:
                damping = float(d.text)
        joints.append(dict(parent=parent, child=child, type=jtype, T_cj=T_cj,
                           axis=axis, axis2=axis2, lo=lo, hi=hi, damping=damping))

    by_child = {j["child"]: j for j in joints}
    body_idx = {}

    def add(name):
        if name in body_idx:
            return body_idx[name]
        B = bodies[name]
        j = by_child.get(name)
        R_cj, p_cj = j["T_cj"] if j is not None else (np.eye(3), np.zeros(3))
        # new child frame = joint frame; re-express body data
        R_jc, p_jc = _inv(R_cj, p_cj)
        com_j = R_jc @ B["com"] + p_jc
        moment_j = R_jc @ B["moment"] @ R_jc.T
        if j is None or j["parent"] == "world":
            parent_idx = -1
            R_wp, p_wp = np.eye(3), np.zeros(3)
            jtype = j["type"] if j is not None else JointType.FREE
        else:
            parent_idx = add(j["parent"])
            P = bodies[j["parent"]]
            R_wp, p_wp = P["R"], P["p"]
            jtype = j["type"]
        # X_tree = X_wp^-1 . X_wc . T_cj   (joint frame in parent frame at q=0)
        R_wc, p_wc = _mul(bodies[name]["R"], bodies[name]["p"], R_cj, p_cj)
        Rpi, ppi = _inv(R_wp, p_wp)
        X_rot, X_pos = _mul(Rpi, ppi, R_wc, p_wc)
        # axes are given in the joint (child) frame already
        idx = builder.add_body(
            parent=parent_idx, jtype=jtype, X_rot=X_rot, X_pos=X_pos,
            axis=j["axis"] if j is not None else (0, 0, 1),
            axis2=j["axis2"] if j is not None else (0, 1, 0),
            mass=B["mass"], com=com_j, inertia=moment_j,
            damping=j["damping"] if j is not None else 0.0,
            q_lo=j["lo"] if j is not None else -1e9,
            q_hi=j["hi"] if j is not None else 1e9,
            name=name,
        )
        body_idx[name] = idx
        for (gtype, size, R_bs, p_bs) in B["geoms"]:
            Rg, pg = _mul(R_jc, p_jc, R_bs, p_bs)
            builder.add_geom(idx, gtype, size=size, rot=Rg, pos=pg,
                             friction=friction, restitution=restitution)
        return idx

    first = None
    for name in bodies:
        i = add(name)
        first = i if first is None else first
    return first
