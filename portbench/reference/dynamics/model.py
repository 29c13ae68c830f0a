# Frozen copy of diffdart_tpu_torch/dynamics/model.py, the benchmark's plain reference; imports
# rewritten to portbench.reference. Later changes to the program do not reach it.
"""Model/State containers: structure-of-arrays articulated-body description.

Counterpart of diffdart_tpu/dynamics/model.py. A `Model` is a frozen
dataclass: static topology as Python tuples, physical parameters as torch
tensors on one device in one floating dtype. Field names, shapes and the
builder's conventions are those of the JAX package, so a model built by
either package carries the same numbers.

Conventions: body 0..nbody-1 in topological order (parent[i] < i); the world
is parent -1. Each body is connected to its parent by exactly one joint; the
child body frame coincides with the joint's successor frame.

This copy keeps what building a model takes; the program's helpers that
edit a built model (bilateral constraints, servos, joint friction) and move
its fields to numpy are left out. `ModelBuilder.add_mimic` records a mimic
at build time. A CONVEX geom takes a vertex cloud (`add_geom(..., verts=)`); at
`finalize` each is reduced to its convex hull (io/mesh.py::convex_hull,
at most `hull_max_verts` vertices) and the hulls are padded to one size as
the JAX package pads them: vertices by repeating vertex 0, faces by
repeating face 0 (`hull_vcounts` / `hull_fcounts` give the real counts).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


class JointType:
    """Static joint-type ids (the same integers as the JAX package)."""

    WELD = 0
    REVOLUTE = 1
    PRISMATIC = 2
    SCREW = 3
    UNIVERSAL = 4
    BALL = 5
    EULER = 6
    TRANSLATIONAL = 7
    TRANSLATIONAL2D = 8
    PLANAR = 9
    FREE = 10

    # (nq, nv) per type
    DOF = {
        WELD: (0, 0),
        REVOLUTE: (1, 1),
        PRISMATIC: (1, 1),
        SCREW: (1, 1),
        UNIVERSAL: (2, 2),
        BALL: (4, 3),
        EULER: (3, 3),
        TRANSLATIONAL: (3, 3),
        TRANSLATIONAL2D: (2, 2),
        PLANAR: (3, 3),
        FREE: (7, 6),
    }


class GeomType:
    """Collision/visual geometry primitives (the same integers as the JAX
    package)."""

    SPHERE = 0
    BOX = 1
    CAPSULE = 2
    PLANE = 3  # static half-space: normal z in geom frame, passes through origin
    CYLINDER = 4
    ELLIPSOID = 5
    CONVEX = 6


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device with no GPU present raises
    instead of silently falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Model:
    # ---- static topology ----
    parent: tuple  # (nbody,) parent body, -1 = world
    jtype: tuple  # (nbody,) JointType per body
    q_off: tuple  # (nbody,) start of body's q slice
    v_off: tuple  # (nbody,) start of body's v slice
    nq: int
    nv: int
    geom_body: tuple  # (ngeom,) owning body (-1 = world)
    geom_type: tuple  # (ngeom,) GeomType
    col_pairs: tuple  # ((g1, g2), ...)
    geom_hull: tuple = ()
    hull_vcounts: tuple = ()
    hull_fcounts: tuple = ()

    # ---- parameters (tensors, one dtype, one device) ----
    X_rot: torch.Tensor = None  # (nbody, 3, 3) parent frame -> joint frame
    X_pos: torch.Tensor = None  # (nbody, 3)
    axis: torch.Tensor = None  # (nbody, 3) primary joint axis (child frame)
    axis2: torch.Tensor = None  # (nbody, 3) secondary axis (universal/planar/2d)
    screw_pitch: torch.Tensor = None  # (nbody,)
    mass: torch.Tensor = None  # (nbody,)
    com: torch.Tensor = None  # (nbody, 3) COM in body frame
    inertia: torch.Tensor = None  # (nbody, 3, 3) rotational inertia about COM
    damping: torch.Tensor = None  # (nv,)
    armature: torch.Tensor = None  # (nv,)
    servo_target: torch.Tensor = None  # (nv,) commanded velocity of servo rows
    force_limit: torch.Tensor = None  # (nv,) |force| limit of servo rows
    joint_friction: torch.Tensor = None  # (nv,) dry joint friction force
    spring_stiff: torch.Tensor = None  # (nv,)
    q_rest: torch.Tensor = None  # (nv,)
    q_lo: torch.Tensor = None  # (nv,)
    q_hi: torch.Tensor = None  # (nv,)
    gravity: torch.Tensor = None  # (3,)
    dt: torch.Tensor = None  # ()
    geom_size: torch.Tensor = None  # (ngeom, 3)
    geom_rot: torch.Tensor = None  # (ngeom, 3, 3) geom frame in body frame
    geom_pos: torch.Tensor = None  # (ngeom, 3)
    geom_friction: torch.Tensor = None  # (ngeom,)
    geom_restitution: torch.Tensor = None  # (ngeom,)
    hull_verts: torch.Tensor = None  # (nhull, HV, 3)
    hull_face_n: torch.Tensor = None  # (nhull, HF, 3)
    hull_face_b: torch.Tensor = None  # (nhull, HF)

    # ---- contact solver configuration (static) ----
    contact_iters: int = 4
    contact_solver: str = "lowrank"
    contact_budget: int = 0
    pair_budget: int = 0
    lcp_polish: bool = True
    lcp_pivot_iters: int = 16
    contact_cfm: float = 1e-6
    lcp_dtype: str = "state"
    baumgarte_erp: float = 0.2
    limit_iters_extra: int = 0
    enable_joint_limits: bool = True
    has_joint_limits: bool = False
    limited_dofs: tuple = ()
    has_springs: bool = False
    servo_dofs: tuple = ()
    friction_dofs: tuple = ()
    ball_pairs: tuple = ()
    weld_pairs: tuple = ()
    ball_anchor_a: torch.Tensor = None  # (nball, 3)
    ball_anchor_b: torch.Tensor = None
    weld_anchor_a: torch.Tensor = None  # (nweld, 3)
    weld_anchor_b: torch.Tensor = None
    weld_rel_rot: torch.Tensor = None  # (nweld, 3, 3)
    mimic_pairs: tuple = ()  # ((dof, src), ...)
    mimic_mult: torch.Tensor = None  # (nmimic,)
    mimic_offset: torch.Tensor = None

    def replace(self, **changes) -> "Model":
        return dataclasses.replace(self, **changes)

    @property
    def nbody(self) -> int:
        return len(self.parent)

    @property
    def ngeom(self) -> int:
        return len(self.geom_body)

    @property
    def dtype(self) -> torch.dtype:
        return self.mass.dtype

    @property
    def device(self) -> torch.device:
        return self.mass.device

    def body_nq(self, i: int) -> int:
        return JointType.DOF[self.jtype[i]][0]

    def body_nv(self, i: int) -> int:
        return JointType.DOF[self.jtype[i]][1]

    @property
    def dof_body(self) -> tuple:
        """(nv,) owning body index per velocity dof."""
        out = []
        for i in range(self.nbody):
            out += [i] * self.body_nv(i)
        return tuple(out)

    @property
    def ancestor_mask(self) -> np.ndarray:
        """(nbody, nv) float mask: mask[b, j] = 1 iff dof j is on the kinematic
        path from the world to body b."""
        mask = np.zeros((self.nbody, self.nv), dtype=np.float64)
        for b in range(self.nbody):
            a = b
            while a >= 0:
                lo, n = self.v_off[a], self.body_nv(a)
                mask[b, lo : lo + n] = 1.0
                a = self.parent[a]
        return mask

    def astype(self, dtype) -> "Model":
        """The model with every floating-point tensor field cast to `dtype`
        (static topology and configuration untouched)."""
        return self.replace(**{
            name: x.to(dtype) for name in _ARRAY_FIELDS
            if (x := getattr(self, name)) is not None and x.is_floating_point()})

    @property
    def quat_dof_mask(self) -> np.ndarray:
        """(nq,) bool: True for q entries that are quaternion components."""
        m = np.zeros(self.nq, dtype=bool)
        for i in range(self.nbody):
            if self.jtype[i] in (JointType.BALL, JointType.FREE):
                m[self.q_off[i]:self.q_off[i] + 4] = True
        return m

    def neutral_q(self, dtype=None) -> torch.Tensor:
        q = np.zeros(self.nq)
        for i in range(self.nbody):
            if self.jtype[i] in (JointType.BALL, JointType.FREE):
                q[self.q_off[i]] = 1.0  # quaternion w
        return torch.as_tensor(q, dtype=dtype or self.dtype, device=self.device)


@dataclasses.dataclass(frozen=True)
class State:
    """Simulation state: q (nq,) or (B, nq), v (nv,) or (B, nv), time t."""

    q: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor = None


def make_state(model: Model, q=None, v=None, dtype=None) -> State:
    if dtype is None:
        dtype = model.dtype if q is None or not torch.is_tensor(q) else q.dtype
    dev = model.device
    if q is None:
        q = model.neutral_q(dtype)
    if v is None:
        v = torch.zeros(model.nv, dtype=dtype, device=dev)
    return State(
        q=torch.as_tensor(q, dtype=dtype, device=dev),
        v=torch.as_tensor(v, dtype=dtype, device=dev),
        t=torch.zeros((), dtype=dtype, device=dev),
    )


_ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(Model)
    if f.type in ("torch.Tensor", torch.Tensor)
)


def _to_tuple(x):
    if isinstance(x, (list, tuple, np.ndarray)):
        return tuple(_to_tuple(y) for y in x)
    return x.item() if isinstance(x, np.generic) else x


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Body:
    parent: int
    jtype: int
    X_rot: Any
    X_pos: Any
    axis: Any
    axis2: Any
    screw_pitch: float
    mass: float
    com: Any
    inertia: Any
    damping: float
    armature: float
    spring_stiff: float
    q_rest: float
    q_lo: float
    q_hi: float
    name: str


@dataclasses.dataclass
class _Geom:
    body: int
    gtype: int
    size: Any
    rot: Any
    pos: Any
    friction: float
    restitution: float
    verts: Any = None  # CONVEX only: the vertex cloud, hulled at finalize


class ModelBuilder:
    """Programmatic model construction, body by body."""

    def __init__(self, gravity=(0.0, 0.0, -9.81), dt=1e-3, hull_max_verts: int = 32):
        self.bodies: list[_Body] = []
        self.geoms: list[_Geom] = []
        self.gravity = gravity
        self.dt = dt
        self.hull_max_verts = hull_max_verts
        self._names: dict[str, int] = {}
        self.collision_filter: set = set()
        self.mimics: list = []  # (child_body, src_body, mult, offset)

    def add_body(
        self,
        parent: int = -1,
        jtype: int = JointType.REVOLUTE,
        X_rot=None,
        X_pos=(0.0, 0.0, 0.0),
        axis=(0.0, 0.0, 1.0),
        axis2=(0.0, 1.0, 0.0),
        screw_pitch: float = 0.0,
        mass: float = 1.0,
        com=(0.0, 0.0, 0.0),
        inertia=None,
        damping: float = 0.0,
        armature: float = 0.0,
        spring_stiff: float = 0.0,
        q_rest: float = 0.0,
        q_lo: float = -1e9,
        q_hi: float = 1e9,
        name: str | None = None,
    ) -> int:
        idx = len(self.bodies)
        if parent >= idx:
            raise ValueError("bodies must be added in topological order (parent < child)")
        if inertia is None:
            inertia = np.eye(3) * 0.1 * mass
        if X_rot is None:
            X_rot = np.eye(3)
        name = name or f"body{idx}"
        self.bodies.append(
            _Body(parent, jtype, np.asarray(X_rot, np.float64), np.asarray(X_pos, np.float64),
                  np.asarray(axis, np.float64), np.asarray(axis2, np.float64), screw_pitch,
                  mass, np.asarray(com, np.float64), np.asarray(inertia, np.float64),
                  damping, armature, spring_stiff, q_rest, q_lo, q_hi, name)
        )
        self._names[name] = idx
        return idx

    def add_mimic(self, child_body: int, src_body: int,
                  multiplier: float = 1.0, offset: float = 0.0) -> None:
        """q_child = multiplier * q_src + offset (URDF <mimic>); both joints
        must be single-dof, checked at finalize."""
        self.mimics.append((int(child_body), int(src_body),
                            float(multiplier), float(offset)))

    def add_geom(
        self,
        body: int,
        gtype: int,
        size=(0.1, 0.0, 0.0),
        rot=None,
        pos=(0.0, 0.0, 0.0),
        friction: float = 0.8,
        restitution: float = 0.0,
        verts=None,
    ) -> int:
        """For gtype=CONVEX pass `verts` (N, 3), the mesh vertices in the geom
        frame: the convex hull is built at finalize, and `size` becomes the
        half-extents of the vertices' bounding box about the geom origin."""
        if rot is None:
            rot = np.eye(3)
        if gtype == GeomType.CONVEX:
            if verts is None:
                raise ValueError("CONVEX geom requires verts")
            verts = np.asarray(verts, np.float64)
            lo, hi = verts.min(axis=0), verts.max(axis=0)
            size = (hi - lo) / 2.0 + np.abs(hi + lo) / 2.0  # bounding box about the origin
        self.geoms.append(
            _Geom(body, gtype, np.asarray(size, np.float64), np.asarray(rot, np.float64),
                  np.asarray(pos, np.float64), friction, restitution, verts)
        )
        return len(self.geoms) - 1

    def exclude_pair(self, g1: int, g2: int):
        self.collision_filter.add((min(g1, g2), max(g1, g2)))

    def body_index(self, name: str) -> int:
        return self._names[name]

    def _default_pairs(self) -> tuple:
        """All geom pairs except same-body, parent-child adjacent bodies,
        world-world, plane-plane and explicitly filtered pairs."""
        pairs = []
        for a in range(len(self.geoms)):
            for b in range(a + 1, len(self.geoms)):
                ba, bb = self.geoms[a].body, self.geoms[b].body
                if ba == bb:
                    continue
                if ba >= 0 and bb >= 0 and (self.bodies[ba].parent == bb or self.bodies[bb].parent == ba):
                    continue
                if ba < 0 and bb < 0:
                    continue
                if (a, b) in self.collision_filter:
                    continue
                ta, tb = self.geoms[a].gtype, self.geoms[b].gtype
                if ta == GeomType.PLANE and tb == GeomType.PLANE:
                    continue
                pairs.append((a, b))
        return tuple(pairs)

    def finalize(self, dtype=torch.float32, device="cuda") -> Model:
        dev = resolve_device(device)
        nb = len(self.bodies)
        q_off, v_off = [], []
        nq = nv = 0
        for b in self.bodies:
            q_off.append(nq)
            v_off.append(nv)
            dq, dv = JointType.DOF[b.jtype]
            nq += dq
            nv += dv
        damping = np.zeros(nv)
        armature = np.zeros(nv)
        spring = np.zeros(nv)
        q_rest = np.zeros(nv)
        q_lo = np.full(nv, -1e9)
        q_hi = np.full(nv, 1e9)
        for i, b in enumerate(self.bodies):
            lo, n = v_off[i], JointType.DOF[b.jtype][1]
            damping[lo : lo + n] = b.damping
            armature[lo : lo + n] = b.armature
            spring[lo : lo + n] = b.spring_stiff
            q_rest[lo : lo + n] = b.q_rest
            q_lo[lo : lo + n] = b.q_lo
            q_hi[lo : lo + n] = b.q_hi

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=dev)

        def stack(attr, default_shape):
            if nb == 0:
                return t(np.zeros((0,) + default_shape))
            return t(np.stack([getattr(b, attr) for b in self.bodies]))

        ngeom = len(self.geoms)
        geom_hull, hulls = _build_hulls(self.geoms, self.hull_max_verts)
        mimic_pairs = []
        for (cb, sb, mult, off) in self.mimics:
            for bi, role in ((cb, "mimicking"), (sb, "mimicked")):
                if JointType.DOF[self.bodies[bi].jtype][1] != 1:
                    raise ValueError(
                        f"mimic: {role} joint on body {bi} must be single-dof")
            mimic_pairs.append((v_off[cb], v_off[sb]))

        return Model(
            parent=tuple(b.parent for b in self.bodies),
            jtype=tuple(b.jtype for b in self.bodies),
            q_off=tuple(q_off),
            v_off=tuple(v_off),
            nq=nq,
            nv=nv,
            geom_body=tuple(g.body for g in self.geoms),
            geom_type=tuple(g.gtype for g in self.geoms),
            col_pairs=self._default_pairs(),
            X_rot=stack("X_rot", (3, 3)),
            X_pos=stack("X_pos", (3,)),
            axis=stack("axis", (3,)),
            axis2=stack("axis2", (3,)),
            screw_pitch=t([b.screw_pitch for b in self.bodies]),
            mass=t([b.mass for b in self.bodies]),
            com=stack("com", (3,)),
            inertia=stack("inertia", (3, 3)),
            damping=t(damping),
            armature=t(armature),
            spring_stiff=t(spring),
            q_rest=t(q_rest),
            q_lo=t(q_lo),
            q_hi=t(q_hi),
            gravity=t(self.gravity),
            dt=t(self.dt),
            geom_size=t(np.stack([g.size for g in self.geoms]) if ngeom else np.zeros((0, 3))),
            geom_rot=t(np.stack([g.rot for g in self.geoms]) if ngeom else np.zeros((0, 3, 3))),
            geom_pos=t(np.stack([g.pos for g in self.geoms]) if ngeom else np.zeros((0, 3))),
            geom_friction=t([g.friction for g in self.geoms]),
            geom_restitution=t([g.restitution for g in self.geoms]),
            geom_hull=geom_hull,
            hull_vcounts=tuple(h[0].shape[0] for h in hulls),
            hull_fcounts=tuple(h[1].shape[0] for h in hulls),
            **{name: t(x) for name, x in _pad_hulls(hulls).items()},
            has_joint_limits=bool(np.any(q_lo > -1e8) or np.any(q_hi < 1e8)),
            limited_dofs=tuple(int(i) for i in np.nonzero((q_lo > -1e8) | (q_hi < 1e8))[0]),
            has_springs=bool(np.any(spring != 0.0)),
            servo_target=t(np.zeros(nv)),
            force_limit=t(np.full((nv,), 1e9)),
            joint_friction=t(np.zeros(nv)),
            servo_dofs=(),
            friction_dofs=(),
            ball_anchor_a=t(np.zeros((0, 3))),
            ball_anchor_b=t(np.zeros((0, 3))),
            weld_anchor_a=t(np.zeros((0, 3))),
            weld_anchor_b=t(np.zeros((0, 3))),
            weld_rel_rot=t(np.zeros((0, 3, 3))),
            mimic_pairs=tuple(mimic_pairs),
            mimic_mult=t([m for (_, _, m, _) in self.mimics]),
            mimic_offset=t([o for (_, _, _, o) in self.mimics]),
        )


def _build_hulls(geoms, max_verts):
    """(geom_hull, hulls): each CONVEX geom's hull slot (-1 for the others)
    and its (vertices, face normals, face offsets), in geom order."""
    from portbench.reference.io.mesh import convex_hull

    geom_hull, hulls = [], []
    for g in geoms:
        if g.gtype == GeomType.CONVEX:
            geom_hull.append(len(hulls))
            hulls.append(convex_hull(g.verts, max_verts=max_verts))
        else:
            geom_hull.append(-1)
    return tuple(geom_hull), hulls


def _pad_hulls(hulls) -> dict:
    """The hull buffers, each hull padded to the largest: vertices by
    repeating vertex 0, faces (normal and offset) by repeating face 0 (a
    repeated vertex or plane changes no support or extremum)."""
    if not hulls:
        return dict(hull_verts=np.zeros((0, 0, 3)), hull_face_n=np.zeros((0, 0, 3)),
                    hull_face_b=np.zeros((0, 0)))

    def pad(k, n):
        return np.stack([np.concatenate([h[k], np.repeat(h[k][:1], n - h[k].shape[0], 0)])
                         for h in hulls])

    HV = max(h[0].shape[0] for h in hulls)
    HF = max(h[1].shape[0] for h in hulls)
    return dict(hull_verts=pad(0, HV), hull_face_n=pad(1, HF), hull_face_b=pad(2, HF))
