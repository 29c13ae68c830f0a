"""URDF parser -> ModelBuilder (host side, run once at build time).

Counterpart of diffdart_tpu/io/urdf.py, on xml.etree and numpy: links,
joints, inertials, collision shapes and <mimic> joints. A joint's <origin>
is the transform from the parent link frame to the joint frame, and the
child link frame is the joint frame, which is the Model's own convention.

A <cylinder> is imported as a capsule of the same radius and length. A
<mesh> (STL or OBJ, io/mesh.py) becomes a CONVEX geom whose hull is built
at ModelBuilder.finalize. A link with no <inertial> gets its mass, COM and
inertia from its collision shapes (dynamics/shapes.py).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from diffdart_tpu_torch.dynamics.model import GeomType, JointType

_JOINT_MAP = {
    "revolute": JointType.REVOLUTE,
    "continuous": JointType.REVOLUTE,
    "prismatic": JointType.PRISMATIC,
    "fixed": JointType.WELD,
    "floating": JointType.FREE,
    "ball": JointType.BALL,
    "planar": JointType.PLANAR,
}


def _floats(s, default):
    if s is None:
        return np.asarray(default, float)
    return np.array([float(x) for x in s.split()], dtype=float)


def _rpy_to_mat(rpy):
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _origin(el):
    if el is None:
        return np.eye(3), np.zeros(3)
    o = el.find("origin")
    if o is None:
        return np.eye(3), np.zeros(3)
    xyz = _floats(o.get("xyz"), [0, 0, 0])
    rpy = _floats(o.get("rpy"), [0, 0, 0])
    return _rpy_to_mat(rpy), xyz


def parse_urdf(path_or_str: str, mesh_dir: str | None = None, density: float = 1000.0):
    """Parse URDF XML into an intermediate dict tree (links, joints).

    mesh_dir: base directory for resolving <mesh filename=...> references
    (defaults to the URDF's own directory when a path is given).
    """
    if os.path.exists(path_or_str):
        root = ET.parse(path_or_str).getroot()
        if mesh_dir is None:
            mesh_dir = os.path.dirname(os.path.abspath(path_or_str))
    else:
        root = ET.fromstring(path_or_str)
    if root.tag != "robot":
        raise ValueError("not a URDF <robot> document")

    links = {}
    for link in root.findall("link"):
        name = link.get("name")
        inertial = link.find("inertial")
        has_inertial = inertial is not None
        mass, com_R, com_p, inertia = 1e-6, np.eye(3), np.zeros(3), np.eye(3) * 1e-9
        if has_inertial:
            com_R, com_p = _origin(inertial)
            m_el = inertial.find("mass")
            if m_el is not None:
                mass = float(m_el.get("value"))
            i_el = inertial.find("inertia")
            if i_el is not None:
                ixx = float(i_el.get("ixx", 0))
                iyy = float(i_el.get("iyy", 0))
                izz = float(i_el.get("izz", 0))
                ixy = float(i_el.get("ixy", 0))
                ixz = float(i_el.get("ixz", 0))
                iyz = float(i_el.get("iyz", 0))
                I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
                # URDF inertia is in the inertial (com) frame; rotate to link frame
                inertia = com_R @ I @ com_R.T
        geoms = []
        for col in link.findall("collision"):
            g = _parse_geom(col, mesh_dir)
            if g is not None:
                geoms.append(g)
        if not has_inertial and geoms:
            # exact mass properties from the collision geometry at
            # uniform density
            from diffdart_tpu_torch.dynamics.shapes import body_mass_properties

            try:
                mass, com_p, inertia = body_mass_properties(geoms, density=density)
            except ValueError:
                pass  # massless (e.g. plane-only) links keep the epsilon default
        links[name] = dict(mass=mass, com=com_p, inertia=inertia, geoms=geoms)

    joints = []
    for j in root.findall("joint"):
        jtype = j.get("type")
        if jtype not in _JOINT_MAP:
            raise ValueError(f"unsupported URDF joint type: {jtype}")
        R, p = _origin(j)
        axis = _floats(j.find("axis").get("xyz"), [1, 0, 0]) if j.find("axis") is not None else np.array([1.0, 0, 0])
        lim = j.find("limit")
        lo, hi = -1e9, 1e9
        if lim is not None and jtype in ("revolute", "prismatic"):
            lo = float(lim.get("lower", -1e9))
            hi = float(lim.get("upper", 1e9))
        dyn = j.find("dynamics")
        damping = float(dyn.get("damping", 0)) if dyn is not None else 0.0
        mimic_el = j.find("mimic")
        mimic = None
        if mimic_el is not None:
            mimic = dict(
                joint=mimic_el.get("joint"),
                multiplier=float(mimic_el.get("multiplier", 1.0)),
                offset=float(mimic_el.get("offset", 0.0)),
            )
        joints.append(
            dict(
                name=j.get("name"),
                type=_JOINT_MAP[jtype],
                parent=j.find("parent").get("link"),
                child=j.find("child").get("link"),
                R=R, p=p, axis=axis, lo=lo, hi=hi, damping=damping,
                mimic=mimic,
            )
        )
    return dict(name=root.get("name", "robot"), links=links, joints=joints)


def _parse_geom(col_el, mesh_dir=None):
    geo = col_el.find("geometry")
    if geo is None:
        return None
    R, p = _origin(col_el)
    if geo.find("box") is not None:
        size = _floats(geo.find("box").get("size"), [0.1, 0.1, 0.1]) / 2.0
        return dict(type=GeomType.BOX, size=size, R=R, p=p)
    if geo.find("sphere") is not None:
        r = float(geo.find("sphere").get("radius"))
        return dict(type=GeomType.SPHERE, size=np.array([r, 0, 0]), R=R, p=p)
    if geo.find("cylinder") is not None:
        r = float(geo.find("cylinder").get("radius"))
        L = float(geo.find("cylinder").get("length"))
        hl = max(L / 2.0 - r, 1e-4)  # capsule end-caps stay inside the cylinder length
        return dict(type=GeomType.CAPSULE, size=np.array([r, hl, 0]), R=R, p=p)
    m_el = geo.find("mesh")
    if m_el is not None:
        from diffdart_tpu_torch.io.mesh import load_mesh

        scale = _floats(m_el.get("scale"), [1, 1, 1])
        fname = m_el.get("filename", "")
        path = resolve_mesh_path(fname, mesh_dir)
        verts, faces = load_mesh(path, scale=scale)
        lo, hi = verts.min(axis=0), verts.max(axis=0)
        return dict(
            type=GeomType.CONVEX,
            size=(hi - lo) / 2.0,
            R=R, p=p,
            verts=verts, faces=faces,
            from_mesh=True,
        )
    return None


def resolve_mesh_path(fname: str, mesh_dir: str | None) -> str:
    """Resolve a URDF mesh reference: package:// and file:// URIs, absolute
    paths, and paths relative to the URDF directory. Raises on a miss
    rather than make up collision geometry."""
    if fname.startswith("file://"):
        fname = fname[len("file://"):]
    candidates = []
    if fname.startswith("package://"):
        rel = fname[len("package://"):]
        if mesh_dir:
            # try the full package path and with the package name stripped
            candidates.append(os.path.join(mesh_dir, rel))
            parts = rel.split("/", 1)
            if len(parts) == 2:
                candidates.append(os.path.join(mesh_dir, parts[1]))
    else:
        if os.path.isabs(fname):
            candidates.append(fname)
        if mesh_dir:
            candidates.append(os.path.join(mesh_dir, fname))
        candidates.append(fname)
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(
        f"URDF mesh {fname!r} not found (searched {candidates}); "
        "pass mesh_dir= or fix the asset path"
    )


def load_urdf_into_builder(
    builder,
    path: str,
    root_joint: int = JointType.FREE,
    friction: float = 0.8,
    restitution: float = 0.0,
    skip_meshes: bool = False,
    mesh_dir: str | None = None,
):
    """Emit bodies/geoms into a ModelBuilder in topological order.

    root_joint: joint type attaching the root link to the world (URDF leaves
    this implicit; the default is a FREE joint).
    skip_meshes: drop mesh-derived collision geoms (visual-only assets)."""
    urdf = parse_urdf(path, mesh_dir=mesh_dir)
    links, joints = urdf["links"], urdf["joints"]
    children = {}
    has_parent = set()
    for j in joints:
        children.setdefault(j["parent"], []).append(j)
        has_parent.add(j["child"])
    roots = [n for n in links if n not in has_parent]
    if len(roots) != 1:
        raise ValueError(f"URDF must have exactly one root link, got {roots}")

    body_idx = {}

    def add_link(link_name, parent_idx, jtype, X_rot, X_pos, axis, lo, hi, damping, jname):
        L = links[link_name]
        idx = builder.add_body(
            parent=parent_idx,
            jtype=jtype,
            X_rot=X_rot,
            X_pos=X_pos,
            axis=axis if np.linalg.norm(axis) > 0 else (0, 0, 1),
            mass=max(L["mass"], 1e-8),
            com=L["com"],
            inertia=L["inertia"],
            damping=damping,
            q_lo=lo,
            q_hi=hi,
            name=link_name,
        )
        body_idx[link_name] = idx
        for g in L["geoms"]:
            if skip_meshes and g.get("from_mesh"):
                continue
            builder.add_geom(idx, g["type"], size=g["size"], rot=g["R"], pos=g["p"],
                             friction=friction, restitution=restitution,
                             verts=g.get("verts"))
        for j in sorted(children.get(link_name, []), key=lambda x: x["child"]):
            add_link(j["child"], idx, j["type"], j["R"], j["p"], j["axis"],
                     j["lo"], j["hi"], j["damping"], j["name"])
        return idx

    root_idx = add_link(roots[0], -1, root_joint, np.eye(3), np.zeros(3),
                        np.array([0.0, 0, 1]), -1e9, 1e9, 0.0, "root")

    # mimic couplings (<mimic joint=... multiplier=... offset=.../>): each
    # joint's dof is the dof of its CHILD link's body.
    jbody = {j["name"]: body_idx[j["child"]] for j in joints}
    for j in joints:
        mi = j.get("mimic")
        if mi is None:
            continue
        if mi["joint"] not in jbody:
            raise ValueError(f"mimic references unknown joint {mi['joint']!r}")
        builder.add_mimic(jbody[j["name"]], jbody[mi["joint"]],
                          multiplier=mi["multiplier"], offset=mi["offset"])
    return root_idx
