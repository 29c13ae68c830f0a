"""SDF (Gazebo) scene parser -> ModelBuilder (host side, run once at build
time). Counterpart of diffdart_tpu/io/sdf.py, on xml.etree and numpy.

The subset: <model> with <link> elements posed in the model frame, typed
<joint>s (revolute, prismatic, ball, universal, fixed, free), a joint <pose>
in the CHILD link frame (SDF convention, re-anchored as the .skel loader
does), axis xyz, limits and dynamics, <static> models (geoms anchored to the
world), per-collision <surface><friction><ode><mu> and
<bounce><restitution_coefficient>, and every geometry including <ellipsoid>
and <mesh><uri> (a convex hull, through io/mesh.py::load_mesh and
io/urdf.py::resolve_mesh_path, as the URDF loader does).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from diffdart_tpu_torch.dynamics.model import GeomType, JointType

_JOINT_MAP = {
    "revolute": JointType.REVOLUTE,
    "prismatic": JointType.PRISMATIC,
    "ball": JointType.BALL,
    "universal": JointType.UNIVERSAL,
    "fixed": JointType.WELD,
    "free": JointType.FREE,
    "screw": JointType.SCREW,
}


def _floats(s):
    return np.array([float(x) for x in s.split()], dtype=float)


def _euler_to_mat(rpy):
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _pose(el):
    """<pose>x y z roll pitch yaw</pose> -> (R, p)."""
    if el is None:
        return np.eye(3), np.zeros(3)
    pe = el.find("pose")
    if pe is None or pe.text is None:
        return np.eye(3), np.zeros(3)
    v = _floats(pe.text)
    return _euler_to_mat(v[3:6]), v[:3]


def _mul(Ra, pa, Rb, pb):
    return Ra @ Rb, Ra @ pb + pa


def _inv(R, p):
    return R.T, -R.T @ p


def _parse_geometry(geo, mesh_dir=None):
    """-> (GeomType, size, verts|None) or None."""
    if geo is None:
        return None
    if geo.find("box") is not None:
        size = _floats(geo.find("box").find("size").text) / 2.0
        return GeomType.BOX, size, None
    if geo.find("sphere") is not None:
        return GeomType.SPHERE, np.array([float(geo.find("sphere").find("radius").text), 0, 0]), None
    if geo.find("cylinder") is not None:
        c = geo.find("cylinder")
        r = float(c.find("radius").text)
        L = float(c.find("length").text)
        return GeomType.CYLINDER, np.array([r, L / 2.0, 0]), None
    if geo.find("capsule") is not None:
        c = geo.find("capsule")
        r = float(c.find("radius").text)
        L = float(c.find("length").text)
        return GeomType.CAPSULE, np.array([r, L / 2.0, 0]), None
    if geo.find("ellipsoid") is not None:
        radii = _floats(geo.find("ellipsoid").find("radii").text)
        return GeomType.ELLIPSOID, radii, None
    if geo.find("plane") is not None:
        return GeomType.PLANE, np.zeros(3), None
    m_el = geo.find("mesh")
    if m_el is not None:
        from diffdart_tpu_torch.io.mesh import load_mesh
        from diffdart_tpu_torch.io.urdf import resolve_mesh_path

        uri = m_el.find("uri")
        if uri is None or not uri.text:
            return None
        scale = np.ones(3)
        sc = m_el.find("scale")
        if sc is not None and sc.text:
            scale = _floats(sc.text)
        path = resolve_mesh_path(uri.text.strip(), mesh_dir)
        verts, _faces = load_mesh(path, scale=scale)
        return GeomType.CONVEX, (verts.max(0) - verts.min(0)) / 2.0, verts
    return None


def _surface_params(col, friction, restitution):
    """Per-collision <surface> overrides (SdfParser surface handling)."""
    surf = col.find("surface")
    if surf is None:
        return friction, restitution
    fr = surf.find("friction")
    if fr is not None:
        ode = fr.find("ode")
        mu = ode.find("mu") if ode is not None else None
        if mu is not None and mu.text:
            friction = float(mu.text)
    bo = surf.find("bounce")
    if bo is not None:
        rc = bo.find("restitution_coefficient")
        if rc is not None and rc.text:
            restitution = float(rc.text)
    return friction, restitution


def load_sdf_into_builder(builder, path_or_xml: str, model_name: str | None = None,
                          friction: float = 0.8, restitution: float = 0.0,
                          mesh_dir: str | None = None):
    """Load the first (or named) <model> of an SDF file/string.

    mesh_dir: base directory for <mesh><uri> resolution (defaults to the
    SDF file's directory when a path is given)."""
    if os.path.exists(path_or_xml):
        root = ET.parse(path_or_xml).getroot()
        if mesh_dir is None:
            mesh_dir = os.path.dirname(os.path.abspath(path_or_xml))
    else:
        root = ET.fromstring(path_or_xml)
    if root.tag == "sdf":
        # explicit None test: an Element's truth value is len(children)
        w = root.find("world")
        scope = w if w is not None else root
    else:
        scope = root
    models = scope.findall("model") if scope.find("model") is not None else root.findall(".//model")
    if model_name is not None:
        models = [m for m in models if m.get("name") == model_name]
    if not models:
        raise ValueError("no <model> found in SDF")
    first = None
    for mdl in models:
        idx = _load_model(builder, mdl, friction, restitution, mesh_dir)
        first = idx if first is None else first
    return first


def _is_static(mdl):
    st = mdl.find("static")
    return st is not None and st.text is not None and st.text.strip().lower() in ("true", "1")


def _load_model(builder, mdl, friction, restitution, mesh_dir=None):
    R_wm, p_wm = _pose(mdl)

    if _is_static(mdl):
        # static model (SdfParser static handling): every collision geom is
        # anchored to the world at its world pose; no bodies, no joints
        for link in mdl.findall("link"):
            R_ml, p_ml = _pose(link)
            R_wl, p_wl = _mul(R_wm, p_wm, R_ml, p_ml)
            for col in link.findall("collision"):
                Rg, pg = _pose(col)
                parsed = _parse_geometry(col.find("geometry"), mesh_dir)
                if parsed is None:
                    continue
                gtype, size, verts = parsed
                fr, re_ = _surface_params(col, friction, restitution)
                Rw, pw = _mul(R_wl, p_wl, Rg, pg)
                builder.add_geom(-1, gtype, size=size, rot=Rw, pos=pw,
                                 friction=fr, restitution=re_, verts=verts)
        return None

    links = {}
    for link in mdl.findall("link"):
        R_ml, p_ml = _pose(link)
        R_wl, p_wl = _mul(R_wm, p_wm, R_ml, p_ml)
        mass, com, moment = 1.0, np.zeros(3), np.eye(3) * 1e-3
        inertial = link.find("inertial")
        if inertial is not None:
            m_el = inertial.find("mass")
            if m_el is not None:
                mass = float(m_el.text)
            Rc, pc = _pose(inertial)
            com = pc
            i_el = inertial.find("inertia")
            if i_el is not None:
                def g(tag):
                    e = i_el.find(tag)
                    return float(e.text) if e is not None else 0.0
                I = np.array([
                    [g("ixx"), g("ixy"), g("ixz")],
                    [g("ixy"), g("iyy"), g("iyz")],
                    [g("ixz"), g("iyz"), g("izz")],
                ])
                moment = Rc @ I @ Rc.T
        geoms = []
        for col in link.findall("collision"):
            Rg, pg = _pose(col)
            parsed = _parse_geometry(col.find("geometry"), mesh_dir)
            if parsed is not None:
                fr, re_ = _surface_params(col, friction, restitution)
                geoms.append((parsed[0], parsed[1], Rg, pg, parsed[2], fr, re_))
        links[link.get("name")] = dict(R=R_wl, p=p_wl, mass=mass, com=com,
                                       moment=moment, geoms=geoms)

    joints = []
    for j in mdl.findall("joint"):
        jtype = _JOINT_MAP.get(j.get("type"))
        if jtype is None:
            raise ValueError(f"unsupported SDF joint type {j.get('type')}")
        parent = j.find("parent").text.strip() if j.find("parent") is not None else "world"
        child = j.find("child").text.strip()
        T_cj = _pose(j)  # joint frame in CHILD link frame (SDF convention)
        axis_el = j.find("axis")
        axis = np.array([0.0, 0, 1])
        lo, hi, damping = -1e9, 1e9, 0.0
        if axis_el is not None:
            xyz = axis_el.find("xyz")
            if xyz is not None:
                axis = _floats(xyz.text)
            lim = axis_el.find("limit")
            if lim is not None:
                if lim.find("lower") is not None:
                    lo = float(lim.find("lower").text)
                if lim.find("upper") is not None:
                    hi = float(lim.find("upper").text)
            dyn = axis_el.find("dynamics")
            if dyn is not None and dyn.find("damping") is not None:
                damping = float(dyn.find("damping").text)
        axis2_el = j.find("axis2")
        axis2 = np.array([0.0, 1, 0])
        if axis2_el is not None and axis2_el.find("xyz") is not None:
            axis2 = _floats(axis2_el.find("xyz").text)
        joints.append(dict(parent=parent, child=child, type=jtype, T_cj=T_cj,
                           axis=axis, axis2=axis2, lo=lo, hi=hi, damping=damping))

    by_child = {j["child"]: j for j in joints}
    body_idx = {}

    def add(name):
        if name in body_idx:
            return body_idx[name]
        B = links[name]
        j = by_child.get(name)
        R_cj, p_cj = j["T_cj"] if j is not None else (np.eye(3), np.zeros(3))
        R_jc, p_jc = _inv(R_cj, p_cj)
        com_j = R_jc @ B["com"] + p_jc
        moment_j = R_jc @ B["moment"] @ R_jc.T
        if j is None or j["parent"] in ("world", "map"):
            parent_idx = -1
            R_wp, p_wp = np.eye(3), np.zeros(3)
            jtype = j["type"] if j is not None else JointType.FREE
        else:
            parent_idx = add(j["parent"])
            P = links[j["parent"]]
            R_wp, p_wp = P["R"], P["p"]
            jtype = j["type"]
        R_wc, p_wc = _mul(B["R"], B["p"], R_cj, p_cj)
        Rpi, ppi = _inv(R_wp, p_wp)
        X_rot, X_pos = _mul(Rpi, ppi, R_wc, p_wc)
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
        for (gtype, size, Rg, pg, verts, fr, re_) in B["geoms"]:
            Rgj, pgj = _mul(R_jc, p_jc, Rg, pg)
            builder.add_geom(idx, gtype, size=size, rot=Rgj, pos=pgj,
                             friction=fr, restitution=re_, verts=verts)
        return idx

    first = None
    for name in links:
        i = add(name)
        first = i if first is None else first
    return first
