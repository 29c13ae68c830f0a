# Frozen copy of diffdart_tpu_torch/sim/tilestep.py, the benchmark's plain reference; imports
# rewritten to portbench.reference. Later changes to the program do not reach it.
"""Batch-last fused timestep: the whole constrained step as straight-line
scalar algebra over env vectors (ops/tile.py).

Counterpart of diffdart_tpu/sim/tilestep.py in its lcp='tile' mode. This is
the plain PyTorch version of the fused-step kernel (ops/fused_step.py,
ops/csrc/fused_step.cu): the same arithmetic, op for op, on (B,) tensors. On
the CPU it is what ops/fused_step.py runs; on the card it is what the kernel
is held against. Autograd through it gives the JAX package's gradient: the
LCP warm start and all but the last polish pass are detached, and the
straight-through attachment `best + (g - g.detach())` carries the
implicit-function-theorem tangent of the final pass.

Supported: REVOLUTE / PRISMATIC / PLANAR / WELD / FREE / BALL joints;
capsule-plane, sphere-plane, box-plane (8-corner) and convex-hull-plane
(the 4 deepest hull vertices, _topk_tile_slots) contacts; joint limits on
scalar dofs; velocity-servo and joint Coulomb friction rows; the
matrix-free boxed LCP (phased Jacobi warm start + guarded Woodbury polish).

The hybrid lcp='xla' mode (chosen by lcp='auto' for D > 64 rows or a
contact budget below the slot count) keeps the element algebra up to the
assembled rows, gathers them into batch-first dense (B, D, nv) tensors and
solves them with ops/lcp_lowrank.py::boxed_lcp_lowrank (plain Jacobi
sweeps, polish, pivot refinement, IFT gradient), as _xla_lcp_vnew does in
the JAX package; a contact budget keeps each env's K deepest valid slots.
The fused-step kernel has the convex slots but not the hybrid LCP
(ops/fused_step.py::kernel_unsupported_reason), so on the card a model in
the hybrid mode runs on the vmap stack (sim/fast.py falls back with the
reason named).

Raises TileStepUnsupported for the AABB `pair_budget` broadphase (the JAX
tile step raises there too), for SCREW, UNIVERSAL, EULER, TRANSLATIONAL and
TRANSLATIONAL2D joints and for bilateral ball/weld/mimic rows, which the
JAX tile step lacks as well: such models run on the vmap stack.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.dynamics.model import GeomType, JointType, Model
from portbench.reference.ops import tile as T
from portbench.reference.ops.lcp import _jacobi
from portbench.reference.ops.lcp_lowrank import boxed_lcp_lowrank
from portbench.reference.ops.smalllinalg import cho_solve_small, cholesky_small


class TileStepUnsupported(NotImplementedError):
    pass


def _sg(x):
    if x is None or isinstance(x, (int, float)):
        return x
    return x.detach()


def _dot6(a, b):
    """a, b: ((w0,w1,w2),(v0,v1,v2)) 6-vectors as (w, v) pairs of lists."""
    return T.add(T.dot(a[0], b[0]), T.dot(a[1], b[1]))


def _tangent_basis_const(n):
    """Constant-normal tangent basis (constraints.assembly.tangent_basis of
    the JAX package)."""
    n = np.asarray(n, float)
    ax = int(np.argmin(np.abs(n)))
    e = np.eye(3)[ax]
    t1 = np.cross(n, e)
    t1 = t1 / np.linalg.norm(t1)
    t2 = np.cross(n, t1)
    return t1, t2


_SCALAR_NV = {JointType.WELD: 0, JointType.REVOLUTE: 1, JointType.PRISMATIC: 1, JointType.PLANAR: 3}
# contact slots per geom-vs-plane pair: box 8 corners, capsule 2 ends, sphere 1,
# convex hull its 4 deepest vertices (collision/collide.py's slot counts)
SLOTS = {GeomType.BOX: 8, GeomType.CAPSULE: 2, GeomType.SPHERE: 1, GeomType.CONVEX: 4}


def _np(x):
    return x.detach().cpu().numpy().astype(np.float64)


def dof_qidx(model: Model) -> list:
    """v-index -> q-index map (identity for scalar joints; None for
    quaternion dofs)."""
    out = [None] * model.nv
    for i in range(model.nbody):
        if model.jtype[i] in (JointType.FREE, JointType.BALL):
            continue
        for k in range(_SCALAR_NV[model.jtype[i]]):
            out[model.v_off[i] + k] = model.q_off[i] + k
    return out


def contact_plan(model: Model) -> list:
    """Static collision plan: one dict per geom-vs-fixed-plane pair, in
    col_pairs order. Raises TileStepUnsupported for other pairs."""
    g_rot = _np(model.geom_rot)
    g_pos = _np(model.geom_pos)
    g_size = _np(model.geom_size)
    g_fric = _np(model.geom_friction)
    g_rest = _np(model.geom_restitution)
    gt = model.geom_type
    plan = []
    for (a, b) in model.col_pairs:
        ta, tb = gt[a], gt[b]
        if tb == GeomType.PLANE and ta in SLOTS:
            g, pl = a, b
        elif ta == GeomType.PLANE and tb in SLOTS:
            g, pl = b, a
        else:
            raise TileStepUnsupported(f"fused step: pair types ({ta},{tb}) not supported yet")
        if model.geom_body[pl] >= 0:
            raise TileStepUnsupported("fused step: moving plane not supported")
        plan.append(dict(
            body=int(model.geom_body[g]),
            gtype=int(gt[g]),
            size=g_size[g],
            grot=g_rot[g],
            gpos=g_pos[g],
            n=g_rot[pl][:, 2],
            p_pl=g_pos[pl],
            friction=float(min(g_fric[g], g_fric[pl])),
            restitution=float(g_rest[g] * g_rest[pl]),
        ))
        if gt[g] == GeomType.CONVEX:
            # the hull's real (unpadded) vertices, geom-local, as constants
            h = model.geom_hull[g]
            plan[-1]["verts"] = _np(model.hull_verts)[h][: int(model.hull_vcounts[h])]
    return plan


def check_supported(model: Model, lcp: str = "auto") -> str:
    """Raise TileStepUnsupported unless `model` is in the fused subset;
    return the LCP mode, 'tile' or 'xla' (lcp_mode)."""
    ok_joints = {
        JointType.REVOLUTE, JointType.PRISMATIC, JointType.PLANAR,
        JointType.WELD, JointType.FREE, JointType.BALL,
    }
    for j in model.jtype:
        if j not in ok_joints:
            raise TileStepUnsupported(f"fused step: joint type {j} not supported yet")
    if model.ball_pairs or model.weld_pairs or model.mimic_pairs:
        raise TileStepUnsupported(
            "fused step: bilateral/mimic rows are outside the fused subset (the vmap stack runs them)")
    if int(model.pair_budget or 0):
        raise TileStepUnsupported(
            "fused step: the AABB pair-budget broadphase has no tile form, as in the JAX "
            "package (the vmap stack runs it)")
    qidx = dof_qidx(model)
    spring = _np(model.spring_stiff)
    for i in range(model.nv):
        if qidx[i] is None and float(spring[i]) != 0.0:
            raise TileStepUnsupported("fused step: joint springs on quaternion dofs not supported")
    if model.enable_joint_limits:
        for d in model.limited_dofs:
            if qidx[int(d)] is None:
                raise TileStepUnsupported("fused step: joint limits on quaternion dofs not supported")
    return lcp_mode(model, lcp)


def contact_budget(model: Model, nc: int) -> int:
    """K of the per-env top-K slot selection: the contact budget when it is
    below the slot count `nc`, else 0 (no selection)."""
    budget = int(model.contact_budget or 0)
    return budget if (budget and budget < nc) else 0


def lcp_mode(model: Model, lcp: str = "auto") -> str:
    """'tile' or 'xla'. 'auto' picks the hybrid 'xla' mode for more than 64
    LCP rows (after the budget) or a cutting contact budget, as the JAX
    package does; the budget's per-env row gather has no tile form."""
    nc = sum(SLOTS[p["gtype"]] for p in contact_plan(model))
    K = contact_budget(model, nc)
    D_eff = lcp_rows(model, K or nc)
    if lcp == "auto":
        lcp = "xla" if (D_eff > 64 or K) else "tile"
    if lcp not in ("tile", "xla"):
        raise ValueError(f"build_tile_step: unknown lcp mode {lcp!r}")
    if K and lcp == "tile":
        raise TileStepUnsupported(
            "fused step: the contact budget's top-K selection needs the hybrid lcp='xla' mode "
            "(a per-env row gather has no tile form)")
    return lcp


def lcp_rows(model: Model, nc: int) -> int:
    """Row count D: [nc normals | nc t1 | nc t2 | limits lo | limits hi |
    servo | joint friction]."""
    nlim = len(model.limited_dofs) if model.enable_joint_limits else 0
    return 3 * nc + 2 * nlim + len(model.servo_dofs) + len(model.friction_dofs)


def build_tile_step(model: Model, output: str = "stacked", lcp: str = "auto"):
    """Specialize the full constrained step for `model`.

    output='stacked': step(q, v, tau) on SoA tensors (nq, B), (nv, B),
    (nv, B) -> (q', v') of the same shapes.
    output='tiles': step(q_tuple, v_tuple, tau_tuple) on tuples of (B,)
    tensors -> (q'_tuple, v'_tuple).
    lcp: 'tile' runs the element-wise LCP (_tile_lcp); 'xla' the hybrid
    (_xla_lcp_vnew); 'auto' picks as lcp_mode does.
    """
    lcp = check_supported(model, lcp)
    nb, nv, nq = model.nbody, model.nv, model.nq
    jt = tuple(int(j) for j in model.jtype)
    parent = tuple(int(p) for p in model.parent)
    q_off = tuple(int(o) for o in model.q_off)
    v_off = tuple(int(o) for o in model.v_off)
    X_rot = _np(model.X_rot)
    X_pos = _np(model.X_pos)
    axis = _np(model.axis)
    axis2 = _np(model.axis2)
    mass = _np(model.mass)
    com = _np(model.com)
    inertia = _np(model.inertia)
    damping = _np(model.damping)
    armature = _np(model.armature)
    spring = _np(model.spring_stiff)
    q_rest = _np(model.q_rest)
    anc = model.ancestor_mask
    grav = _np(model.gravity)
    dt = float(model.dt)
    cfm = float(model.contact_cfm)
    erp = float(model.baumgarte_erp)

    # servo / joint-friction rows are constant symmetric-box LCP rows with
    # their targets/limits baked as constants
    servo = tuple(int(d) for d in model.servo_dofs)
    fric = tuple(int(d) for d in model.friction_dofs)
    nservo, nfric = len(servo), len(fric)
    servo_tgt = _np(model.servo_target) if nservo else None
    servo_lim = _np(model.force_limit) if nservo else None
    joint_mu = _np(model.joint_friction) if nfric else None
    qidx = dof_qidx(model)

    plan = contact_plan(model)
    slots = [SLOTS[p["gtype"]] for p in plan]
    nc = sum(slots)
    lim = tuple(int(d) for d in model.limited_dofs) if model.enable_joint_limits else ()
    nlim = len(lim)
    q_lo = _np(model.q_lo)
    q_hi = _np(model.q_hi)
    D = lcp_rows(model, nc)
    K_budget = contact_budget(model, nc)
    lcp_f64, pivot_iters = model.lcp_dtype == "f64", int(model.lcp_pivot_iters)
    iters = int(model.contact_iters)
    polish_passes = 2 if model.lcp_polish else 0

    anc_dofs = [tuple(int(j) for j in np.nonzero(anc[b])[0]) for b in range(nb)]

    def step(q_st, v_st, tau_st):
        q = [q_st[i] for i in range(nq)]
        v = [v_st[i] for i in range(nv)]
        tau = [tau_st[i] for i in range(nv)]
        zero_like = torch.zeros_like(q_st[0])

        # ---------------- FK ----------------
        R = [None] * nb
        P = [None] * nb
        for i in range(nb):
            o = q_off[i]
            if jt[i] == JointType.REVOLUTE:
                Rj = T.exp_so3_const_axis(axis[i], q[o])
                pj = [None, None, None]
            elif jt[i] == JointType.PRISMATIC:
                Rj = T.eye3()
                pj = T.vscale([float(a) for a in axis[i]], q[o])
            elif jt[i] == JointType.PLANAR:
                n_ax = np.cross(axis[i], axis2[i])
                Rj = T.exp_so3_const_axis(n_ax, q[o + 2])
                pj = T.vadd(
                    T.vscale([float(a) for a in axis[i]], q[o]),
                    T.vscale([float(a) for a in axis2[i]], q[o + 1]),
                )
            elif jt[i] in (JointType.FREE, JointType.BALL):
                Rj = T.quat_to_mat_t(T.quat_normalize_t([q[o], q[o + 1], q[o + 2], q[o + 3]]))
                pj = [q[o + 4], q[o + 5], q[o + 6]] if jt[i] == JointType.FREE else [None] * 3
            else:  # WELD
                Rj = T.eye3()
                pj = [None, None, None]
            Xr = [[float(X_rot[i][r, c]) or None for c in range(3)] for r in range(3)]
            Xp = [float(x) or None for x in X_pos[i]]
            R_pc, p_pc = T.tf_compose_t(Xr, Xp, Rj, pj)
            if parent[i] < 0:
                R[i], P[i] = R_pc, p_pc
            else:
                R[i], P[i] = T.tf_compose_t(R[parent[i]], P[parent[i]], R_pc, p_pc)

        # ---------------- world Jacobian columns Sw (per dof) ----------------
        Sw = [None] * nv  # (w, v) pairs of len-3 lists
        dof_body = [None] * nv
        for i in range(nb):
            o = v_off[i]
            if jt[i] == JointType.REVOLUTE:
                rows = [([float(a) or None for a in axis[i]], [None] * 3)]
            elif jt[i] == JointType.PRISMATIC:
                rows = [([None] * 3, [float(a) or None for a in axis[i]])]
            elif jt[i] == JointType.PLANAR:
                n_ax = np.cross(axis[i], axis2[i])
                Rj = T.exp_so3_const_axis(n_ax, q[q_off[i] + 2])
                ra = T.matTvec3(Rj, [float(a) for a in axis[i]])
                rb = T.matTvec3(Rj, [float(a) for a in axis2[i]])
                rows = [([None] * 3, ra), ([None] * 3, rb), ([float(x) or None for x in n_ax], [None] * 3)]
            elif jt[i] == JointType.FREE:
                # S = I6 in the child frame: 3 angular then 3 linear unit rows
                rows = [([1.0 if a == k else None for a in range(3)], [None] * 3) for k in range(3)]
                rows += [([None] * 3, [1.0 if a == k else None for a in range(3)]) for k in range(3)]
            elif jt[i] == JointType.BALL:
                rows = [([1.0 if a == k else None for a in range(3)], [None] * 3) for k in range(3)]
            else:
                rows = []
            for k, (w_l, v_l) in enumerate(rows):
                Sw[o + k] = T.spatial_transform_motion(R[i], P[i], w_l, v_l)
                dof_body[o + k] = i

        # ---------------- body velocities ----------------
        V = []
        for b in range(nb):
            w_acc = [None] * 3
            v_acc = [None] * 3
            for j in anc_dofs[b]:
                w_acc = T.vadd(w_acc, T.vscale(Sw[j][0], v[j]))
                v_acc = T.vadd(v_acc, T.vscale(Sw[j][1], v[j]))
            V.append((w_acc, v_acc))

        # ---------------- world spatial inertia (structured) ----------------
        # n = Ic_w w - m c x (c x w) + m c x v;  f = m v - m c x w
        Iw = []
        for b in range(nb):
            c_w = T.vadd(T.matvec3(R[b], [float(x) for x in com[b]]), P[b])
            Ic = [[float(inertia[b][r, c]) or None for c in range(3)] for r in range(3)]
            Ic_w = T.matmul3(T.matmul3(R[b], Ic), T.transpose3(R[b]))
            Iw.append((float(mass[b]), c_w, Ic_w))

        def iw_apply(b, w, vl):
            m, c, Ic_w = Iw[b]
            cxw = T.cross3(c, w)
            n = T.vadd(
                T.matvec3(Ic_w, w),
                T.vscale(T.vsub(T.cross3(c, vl), T.cross3(c, cxw)), m),
            )
            f = T.vsub(T.vscale(vl, m), T.vscale(cxw, m))
            return n, f

        # ---------------- mass matrix ----------------
        M = [[None] * nv for _ in range(nv)]
        for b in range(nb):
            F_cols = {j: iw_apply(b, Sw[j][0], Sw[j][1]) for j in anc_dofs[b]}
            for jj in anc_dofs[b]:
                for ii in anc_dofs[b]:
                    if ii > jj:
                        continue
                    M[ii][jj] = T.add(M[ii][jj], _dot6(Sw[ii], F_cols[jj]))
        for i in range(nv):
            extra = float(armature[i]) + dt * float(damping[i]) + dt * dt * float(spring[i])
            M[i][i] = T.add(M[i][i], extra)
            for j in range(i):
                M[i][j] = M[j][i]

        # ---------------- bias forces C ----------------
        # sdot_j = ad_{V_b} Sw_j (+ dS/dq for PLANAR translation rows)
        sdot = [None] * nv
        for j in range(nv):
            b = dof_body[j]
            w1, u1 = V[b]
            w2, u2 = Sw[j]
            sw = T.cross3(w1, w2)
            sv = T.vadd(T.cross3(w1, u2), T.cross3(u1, w2))
            if jt[b] == JointType.PLANAR and (j - v_off[b]) in (0, 1):
                # d/dt (Rj^T a) = -q2dot (n x (Rj^T a)); world lin = R_b @ that
                n_ax = np.cross(axis[b], axis2[b])
                a_c = axis[b] if j == v_off[b] else axis2[b]
                Rj = T.exp_so3_const_axis(n_ax, q[q_off[b] + 2])
                rta = T.matTvec3(Rj, [float(x) for x in a_c])
                dlin = T.vscale(T.cross3([float(x) or None for x in n_ax], rta), v[v_off[b] + 2])
                sv = T.vsub(sv, T.matvec3(R[b], dlin))
            sdot[j] = (sw, sv)
        C = [None] * nv
        a_grav_v = [float(g) or None for g in grav]
        for b in range(nb):
            aw = [None] * 3
            av = [T.neg(x) for x in a_grav_v]
            for j in anc_dofs[b]:
                aw = T.vadd(aw, T.vscale(sdot[j][0], v[j]))
                av = T.vadd(av, T.vscale(sdot[j][1], v[j]))
            Fn, Ff = iw_apply(b, aw, av)
            # + V x* (I V)
            nIV, fIV = iw_apply(b, V[b][0], V[b][1])
            w1, u1 = V[b]
            Fn = T.vadd(Fn, T.vadd(T.cross3(w1, nIV), T.cross3(u1, fIV)))
            Ff = T.vadd(Ff, T.cross3(w1, fIV))
            for i in anc_dofs[b]:
                C[i] = T.add(C[i], _dot6(Sw[i], (Fn, Ff)))

        # ---------------- unconstrained velocity ----------------
        rhs = []
        for i in range(nv):
            f_j = T.mul(-float(damping[i]), v[i])
            if float(spring[i]):
                f_j = T.sub(f_j, T.mul(float(spring[i]), T.add(T.sub(q[qidx[i]], float(q_rest[i])), T.mul(dt, v[i]))))
            rhs.append(T.add(tau[i], T.sub(f_j, C[i])))
        # Minv columns + v_star (one factorization, nv substitutions)
        L_M = T.chol_factor(M)
        Minv = [[None] * nv for _ in range(nv)]
        for k in range(nv):
            col = T.chol_solve(L_M, [1.0 if i == k else None for i in range(nv)])
            for i in range(nv):
                Minv[i][k] = col[i]
        v_star = [T.add(v[i], T.mul(dt, T.dot(Minv[i], rhs))) for i in range(nv)]

        if D == 0:
            return q_integrate(q, v_star), v_star

        # ---------------- collision (geom vs fixed plane) ----------------
        con_pos, con_depth, con_valid, con_n, con_body, con_mu, con_rest = ([] for _ in range(7))
        for pp in plan:
            b = pp["body"]
            Rg, pg = T.tf_compose_t(
                R[b],
                P[b],
                [[float(pp["grot"][r, c]) or None for c in range(3)] for r in range(3)],
                [float(x) or None for x in pp["gpos"]],
            )
            n_c = [float(x) for x in pp["n"]]
            p_pl = [float(x) for x in pp["p_pl"]]
            if pp["gtype"] == GeomType.BOX:
                # all 8 corners: depth = -(c - pb).n, pos = c + 0.5 depth n
                half = [float(x) for x in pp["size"]]
                cands = []
                for sx in (-1.0, 1.0):
                    for sy in (-1.0, 1.0):
                        for sz in (-1.0, 1.0):
                            loc = [half[0] * sx, half[1] * sy, half[2] * sz]
                            cpt = T.vadd(T.matvec3(Rg, loc), pg)
                            depth = T.neg(T.dot(T.vsub(cpt, p_pl), n_c))
                            cands.append((T.vadd(cpt, T.vscale(n_c, T.mul(0.5, depth))), depth))
            elif pp["gtype"] == GeomType.CONVEX:
                # every hull vertex is a candidate, the 4 deepest become
                # slots: depth = p_pl.n - w.n, pos = the vertex itself
                off = float(np.dot(pp["p_pl"], pp["n"]))
                depths, poss = [], []
                for vloc in pp["verts"]:
                    w = T.vadd(T.matvec3(Rg, [float(x) or None for x in vloc]), pg)
                    depths.append(T.sub(off, T.dot(w, n_c)))
                    poss.append(w)
                cands = [(pos, d) for d, pos in _topk_tile_slots(depths, poss, 4, zero_like)]
            else:
                r_g = float(pp["size"][0])
                if pp["gtype"] == GeomType.CAPSULE:
                    hl = float(pp["size"][1])
                    ax_w = [Rg[0][2], Rg[1][2], Rg[2][2]]
                    ends = [T.vsub(pg, T.vscale(ax_w, hl)), T.vadd(pg, T.vscale(ax_w, hl))]
                else:
                    ends = [pg]
                cands = []
                for cpt in ends:
                    # depth = r - (c - p_pl) . n
                    depth = T.sub(r_g, T.dot(T.vsub(cpt, p_pl), n_c))
                    cands.append((T.vsub(cpt, T.vscale(n_c, T.sub(r_g, T.mul(0.5, depth)))), depth))
            for pos, depth in cands:
                con_pos.append(pos)
                con_depth.append(depth)
                con_valid.append(T.gt0(depth, zero_like))
                con_n.append(n_c)
                con_body.append(b)
                con_mu.append(pp["friction"])
                con_rest.append(pp["restitution"])

        # ---------------- constraint rows ----------------
        # layout: [nc normals | nc t1 | nc t2 | nlim lower | nlim upper |
        #          nservo | nfric]; box_c[i]=c marks a constant box [-c, +c]
        J_rows = [None] * D  # dict dof -> element
        b_vec = [None] * D
        box_c = [None] * D
        valid = [None] * D
        mu_row = [0.0] * D
        fidx = [-1] * D
        for c in range(nc):
            bdy = con_body[c]
            n_c = con_n[c]
            t1_c, t2_c = _tangent_basis_const(n_c)
            lin = {j: T.vadd(Sw[j][1], T.cross3(Sw[j][0], con_pos[c])) for j in anc_dofs[bdy]}
            row_n = {j: T.dot(lin[j], n_c) for j in lin}
            row_t1 = {j: T.dot(lin[j], [float(x) for x in t1_c]) for j in lin}
            row_t2 = {j: T.dot(lin[j], [float(x) for x in t2_c]) for j in lin}
            J_rows[c] = row_n
            J_rows[nc + c] = row_t1
            J_rows[2 * nc + c] = row_t2
            target = T.minimum(T.mul(erp / dt, T.maximum(T.sub(con_depth[c], 1e-5), None)), 2.0)
            if con_rest[c]:
                vn_pre = T.dot([row_n.get(j) for j in range(nv)], v)
                bounce = T.mul(con_rest[c], T.maximum(T.sub(T.neg(vn_pre), 0.01), None))
                target = T.maximum(target, bounce)
            b_vec[c] = T.sub(_sparse_dot(row_n, v_star), target)
            b_vec[nc + c] = _sparse_dot(row_t1, v_star)
            b_vec[2 * nc + c] = _sparse_dot(row_t2, v_star)
            valid[c] = valid[nc + c] = valid[2 * nc + c] = con_valid[c]
            mu_row[nc + c] = mu_row[2 * nc + c] = con_mu[c]
            fidx[nc + c] = fidx[2 * nc + c] = c
        for li, dof in enumerate(lim):
            lo_c, hi_c = float(q_lo[dof]), float(q_hi[dof])
            qd = q[qidx[dof]]
            viol_lo = T.sub(lo_c, qd)
            pred_lo = T.sub(lo_c, T.add(qd, T.mul(dt, v[dof])))
            J_rows[3 * nc + li] = {dof: 1.0}
            b_vec[3 * nc + li] = T.sub(v_star[dof], T.minimum(T.mul(erp / dt, T.maximum(viol_lo, None)), 2.0))
            valid[3 * nc + li] = torch.logical_or(T.gt0(viol_lo, zero_like), T.gt0(pred_lo, zero_like))
            viol_hi = T.sub(qd, hi_c)
            pred_hi = T.sub(T.add(qd, T.mul(dt, v[dof])), hi_c)
            J_rows[3 * nc + nlim + li] = {dof: -1.0}
            b_vec[3 * nc + nlim + li] = T.sub(T.neg(v_star[dof]), T.minimum(T.mul(erp / dt, T.maximum(viol_hi, None)), 2.0))
            valid[3 * nc + nlim + li] = torch.logical_or(T.gt0(viol_hi, zero_like), T.gt0(pred_hi, zero_like))
        base = 3 * nc + 2 * nlim
        for si, dof in enumerate(servo):
            # velocity servo: drive v[dof] -> servo_target within +-F*dt
            J_rows[base + si] = {dof: 1.0}
            b_vec[base + si] = T.sub(v_star[dof], float(servo_tgt[dof]))
            valid[base + si] = True
            box_c[base + si] = float(servo_lim[dof]) * dt
        for fi, dof in enumerate(fric):
            # joint Coulomb friction: drive v[dof] -> 0 within +-mu*dt
            i_row = base + nservo + fi
            J_rows[i_row] = {dof: 1.0}
            b_vec[i_row] = v_star[dof]
            valid[i_row] = True
            box_c[i_row] = float(joint_mu[dof]) * dt

        if lcp == "xla":
            v_new = _xla_lcp_vnew(J_rows, b_vec, valid, mu_row, fidx, M, v_star, nv, D, cfm, iters,
                                  polish_passes, zero_like, K_budget, nc, con_depth, box_c,
                                  lcp_f64, pivot_iters)
            return q_integrate(q, v_new), v_new
        lam = _tile_lcp(J_rows, b_vec, valid, mu_row, fidx, M, Minv, nv, D, cfm, iters,
                        polish_passes, zero_like, box_c)

        # v_new = v_star + Minv J^T lam
        jt_lam = [None] * nv
        for i in range(D):
            for j, el in J_rows[i].items():
                jt_lam[j] = T.fma(jt_lam[j], el, lam[i])
        v_new = [T.add(v_star[k], T.dot(Minv[k], jt_lam)) for k in range(nv)]
        return q_integrate(q, v_new), v_new

    def q_integrate(q, v_new):
        """Geometric position integration: scalar joints q' = q + dt v;
        FREE/BALL quaternion-exponential update (FREE: child-frame linear
        velocity)."""
        out = list(q)
        for i in range(nb):
            o, vo = q_off[i], v_off[i]
            if jt[i] in (JointType.FREE, JointType.BALL):
                quat = T.quat_normalize_t([q[o + k] for k in range(4)])
                w_dt = [T.mul(dt, v_new[vo + k]) for k in range(3)]
                new_quat = T.quat_normalize_t(T.quat_mul_t(quat, T.quat_exp_t(w_dt)))
                out[o:o + 4] = new_quat
                if jt[i] == JointType.FREE:
                    Rq = T.quat_to_mat_t(quat)
                    dp = T.vscale(T.matvec3(Rq, [v_new[vo + 3 + k] for k in range(3)]), dt)
                    for k in range(3):
                        out[o + 4 + k] = T.add(q[o + 4 + k], dp[k])
            else:
                for k in range(_SCALAR_NV[jt[i]]):
                    out[o + k] = T.add(q[o + k], T.mul(dt, v_new[vo + k]))
        return out

    def step_tiles(q_t, v_t, tau_t):
        qn, vn = step(q_t, v_t, tau_t)
        like = q_t[0]
        return (
            tuple(T.materialize(x, like) for x in qn),
            tuple(T.materialize(x, like) for x in vn),
        )

    def step_stacked(q_st, v_st, tau_st):
        qn, vn = step_tiles(tuple(q_st), tuple(v_st), tuple(tau_st))
        return torch.stack(qn), torch.stack(vn)

    if output == "tiles":
        return step_tiles
    if output != "stacked":
        raise ValueError(f"build_tile_step: unknown output {output!r}")
    return step_stacked


def _sparse_dot(row: dict, vec):
    acc = None
    for j, el in row.items():
        acc = T.fma(acc, el, vec[j])
    return acc


def _topk_tile_slots(depths, poss, k, zero_like):
    """Each env's k deepest candidates as fixed slots [(depth, pos)]: deepest
    first, and on an exact tie the lower candidate index wins (the order of
    collision/convex.py::_topk_contacts, a stable argsort of -depth). Each
    slot is a running maximum (a later equal value never replaces it), then
    a first-match sweep; the winner's score drops to -1e30 so the next slot
    takes the next candidate. A hull with fewer than k vertices gets dead
    slots (depth and position structural zeros, never valid)."""
    n = len(depths)
    ms = [T.materialize(d, zero_like) for d in depths]  # scores, winners masked
    out = []
    for _ in range(min(k, n)):
        best = ms[0]
        for j in range(1, n):
            best = torch.maximum(best, ms[j])
        found = None
        sel_depth = None
        sel_pos = [None, None, None]
        for j in range(n):
            eq = ms[j] == best  # exact: best is one of the scores
            sel_j = eq if found is None else torch.logical_and(eq, torch.logical_not(found))
            found = sel_j if found is None else torch.logical_or(found, sel_j)
            sel_depth = T.where(sel_j, depths[j], sel_depth)
            for a in range(3):
                sel_pos[a] = T.where(sel_j, poss[j][a], sel_pos[a], like=zero_like)
            ms[j] = torch.where(sel_j, torch.full_like(ms[j], -1e30), ms[j])
        out.append((sel_depth, sel_pos))
    while len(out) < k:
        out.append((None, [None, None, None]))
    return out


def _xla_lcp_vnew(J_rows, b_vec, valid, mu_row, fidx, M, v_star, nv, D, cfm, iters, passes,
                  zero_like, budget_k, nc, con_depth, box_c, lcp_f64, pivot_iters):
    """The hybrid LCP: the element rows gathered into batch-first dense
    tensors, J (B, D, nv), b (B, D), M (B, nv, nv), and solved by
    ops/lcp_lowrank.py::boxed_lcp_lowrank with plain Jacobi sweeps, the
    polish, the model's pivot refinement and the IFT gradient (float64
    under lcp_dtype='f64'). With a contact budget K, each env keeps its K
    deepest valid slots (a stable sort of the masked depth, as
    lax.top_k orders ties), rows [K normals | K t1 | K t2 | the rest],
    friction coefficients gathered with the slots and the budget's static
    friction index. The model enters only as constants (lcp_f64: the
    float64 island; pivot_iters), so a built step keeps no reference to it.
    Returns v_new as a list of (B,) elements."""
    dtype, dev = zero_like.dtype, zero_like.device
    B = zero_like.shape[0]

    def mat(x):
        return T.materialize(x, zero_like)

    J_b = torch.stack([torch.stack([mat(J_rows[i].get(j)) for j in range(nv)], -1)
                       for i in range(D)], -2)  # (B, D, nv)
    b_b = torch.stack([mat(x) for x in b_vec], -1)  # (B, D)
    v_b = torch.stack([torch.full((B,), bool(x), device=dev) if isinstance(x, bool) else x
                       for x in valid], -1)  # (B, D) bool
    M_b = torch.stack([torch.stack([mat(M[a][c]) for c in range(nv)], -1)
                       for a in range(nv)], -2)  # (B, nv, nv)
    vs_b = torch.stack([mat(x) for x in v_star], -1)  # (B, nv)

    lo_row = torch.zeros(D, dtype=dtype, device=dev)
    hi_row = torch.full((D,), float("inf"), dtype=dtype, device=dev)
    for i, c in enumerate(box_c):
        if c is not None:
            lo_row[i], hi_row[i] = -c, c
    if budget_k:
        K = budget_k
        nrest = D - 3 * nc  # limit, servo and joint-friction rows
        depth_b = torch.stack([mat(d) for d in con_depth], -1)  # (B, nc)
        score = torch.where(v_b[:, :nc], depth_b, torch.full_like(depth_b, -float("inf")))
        idx = torch.sort(score.detach(), dim=-1, descending=True, stable=True).indices[:, :K]
        rest = torch.arange(3 * nc, D, device=dev).expand(B, nrest)
        rows = torch.cat([idx, idx + nc, idx + 2 * nc, rest], dim=1)  # (B, D_eff)
        J_b = torch.gather(J_b, 1, rows.unsqueeze(-1).expand(*rows.shape, nv))
        b_b = torch.gather(b_b, 1, rows)
        v_b = torch.gather(v_b, 1, rows)
        lo_g, hi_g = lo_row[rows], hi_row[rows]
        mu_sel = torch.tensor(mu_row[nc:2 * nc], dtype=dtype, device=dev)[idx]  # (B, K)
        zero_k = torch.zeros_like(mu_sel)
        mu_full = torch.cat([zero_k, mu_sel, mu_sel, zero_k.new_zeros(B, nrest)], dim=1)
        fidx_np = np.full(3 * K + nrest, -1, np.int64)
        fidx_np[K:2 * K] = np.arange(K)
        fidx_np[2 * K:3 * K] = np.arange(K)
        fidx_t = torch.tensor(fidx_np, device=dev)
        mu_b = torch.where(v_b, mu_full, 0.0)
    else:
        fidx_t = torch.tensor(fidx, dtype=torch.long, device=dev)
        mu_c = torch.tensor(mu_row, dtype=dtype, device=dev)
        mu_b = torch.where(v_b, mu_c.expand(B, D), 0.0)
        lo_g, hi_g = lo_row.expand(B, D), hi_row.expand(B, D)
    lo_b = torch.where(v_b, lo_g, 0.0)
    hi_b = torch.where(v_b, hi_g, 0.0)
    cfm_a = torch.tensor(cfm, dtype=dtype, device=dev)
    if lcp_f64 and dtype != torch.float64:
        f64 = torch.float64
        J_b, M_b, b_b, lo_b, hi_b, mu_b, cfm_a = (
            x.to(f64) for x in (J_b, M_b, b_b, lo_b, hi_b, mu_b, cfm_a))
    lam = boxed_lcp_lowrank(J_b, M_b, cfm_a, b_b, lo_b, hi_b, mu_b, fidx_t, iters, passes,
                            _jacobi, pivot_iters)
    dv = cho_solve_small(cholesky_small(M_b), (J_b.transpose(-1, -2) @ lam.unsqueeze(-1)))
    v_new = vs_b + dv.squeeze(-1).to(dtype)
    return [v_new[:, i] for i in range(nv)]


def _sparse_dot_mat(Mat, k, row: dict):
    acc = None
    for j, el in row.items():
        acc = T.fma(acc, Mat[k][j], el)
    return acc


def _tile_lcp(J_rows, b_vec, valid, mu_row, fidx, M, Minv, nv, D, cfm, iters, passes,
              zero_like, box_c):
    """Boxed LCP over element rows: phased-Jacobi warm start + active-set
    Woodbury polish. Contact normals and limit rows have lo=0/hi=inf,
    friction rows the moving box +-mu*lam[fidx], servo/joint-friction rows
    the constant box [-c, +c]; invalid rows are pinned at 0.

    Gradients: everything up to the final polish pass is detached; autograd
    through the final pass's KKT solve is the IFT gradient."""
    is_fr = [fidx[i] >= 0 for i in range(D)]
    is_box = [box_c[i] is not None for i in range(D)]

    def _andv(x, i):
        return x if valid[i] is True else torch.logical_and(x, valid[i])

    # W = Minv J^T : (nv, D) columns, sparse over J rows
    W = [[_sparse_dot_mat(Minv, k, J_rows[i]) for k in range(nv)] for i in range(D)]

    def a_entry(i, j):
        # A[i][j] = J_i . W_j (+cfm on diag)
        acc = None
        for k, el in J_rows[i].items():
            acc = T.fma(acc, el, W[j][k])
        if i == j:
            acc = T.add(acc, cfm)
        return acc

    diag = [T.maximum(a_entry(i, i), 1e-12) for i in range(D)]
    # rowsum of |A| for the adaptive sweep scaling; A is symmetric, so each
    # off-diagonal entry is computed once and credited to both rows
    rs = [[T.abs_(T.materialize(diag[i], zero_like))] for i in range(D)]
    for i in range(D):
        for j in range(i + 1, D):
            e = a_entry(i, j)
            if e is None:
                continue
            ae = T.abs_(e)
            rs[i].append(ae)
            rs[j].append(ae)

    def _sum(elems):
        acc = elems[0]
        for e in elems[1:]:
            acc = T.add(acc, e)
        return acc

    rowsum = [T.maximum(_sum(r), 1e-12) for r in rs]
    scale = [T.div(T.clip(T.div(diag[i], rowsum[i]), 0.3, 0.9), diag[i]) for i in range(D)]

    def matvec(lam):
        # A lam = J (Minv (J^T lam)) + cfm lam, matrix-free
        jt_lam = [None] * nv
        for i in range(D):
            if lam[i] is None:
                continue
            for j, el in J_rows[i].items():
                jt_lam[j] = T.fma(jt_lam[j], el, lam[i])
        u = [T.dot(Minv[k], jt_lam) for k in range(nv)]
        out = []
        for i in range(D):
            acc = T.mul(cfm, lam[i])
            for j, el in J_rows[i].items():
                acc = T.fma(acc, el, u[j])
            out.append(acc)
        return out

    def clip_row(i, cand, lam):
        """Project a candidate onto the row's (possibly moving) box; invalid
        rows pin to 0."""
        if is_fr[i]:
            bound = T.mul(mu_row[i], lam[fidx[i]])  # >= 0 since lam_n >= 0
            c = T.clip(cand, T.neg(bound), bound)
        elif is_box[i]:
            c = T.clip(cand, -box_c[i], box_c[i])
        else:
            c = T.maximum(cand, None)  # lo = 0, hi = inf
        if valid[i] is True:
            return c
        return T.where(valid[i], c, None, like=zero_like)

    # ---- phased Jacobi sweeps (warm start; gradients cut below) ----
    lam = [None] * D
    for _ in range(iters):
        for phase in (False, True):
            r = matvec(lam)
            new = list(lam)
            for i in range(D):
                if is_fr[i] != phase:
                    continue
                cand = T.sub(lam[i], T.mul(scale[i], T.add(r[i], b_vec[i])))
                new[i] = clip_row(i, cand, lam)
            lam = new
    lam = [_sg(x) for x in lam]

    _TOL = 1e-8
    one = torch.ones_like(zero_like)

    def one_pass(lam):
        """One active-set Woodbury pass from iterate `lam`."""
        lam_m = [T.materialize(x, zero_like) for x in lam]
        free, fr_bound, s_sign, pin_val = [], [], [], []
        for i in range(D):
            tol_sc = torch.maximum(torch.abs(lam_m[i]), one) * _TOL
            if is_fr[i]:
                bound = T.materialize(T.mul(mu_row[i], lam[fidx[i]]), zero_like)
                at_lo = lam_m[i] <= tol_sc - bound
                at_hi = lam_m[i] >= bound - tol_sc
                degen = torch.logical_and(at_lo, at_hi)
                free.append(_andv(torch.logical_and(~at_lo, ~at_hi), i))
                # the friction-bound coupling EXCLUDES degenerate rows
                # (zero-width box: lam pins to 0, no B column)
                fr_bound.append(_andv(torch.logical_and(torch.logical_or(at_lo, at_hi), ~degen), i))
                s_sign.append(torch.where(at_hi, one, -one))
                pin_val.append(None)
            elif is_box[i]:
                # constant box [-c, +c]: at-bound rows pin to +-c (nonzero),
                # entering the KKT rhs as cfm*c_pin
                cb = float(box_c[i])
                at_lo = lam_m[i] <= tol_sc - cb
                at_hi = lam_m[i] >= cb - tol_sc
                degen = torch.logical_and(at_lo, at_hi)
                free.append(_andv(torch.logical_and(~at_lo, ~at_hi), i))
                fr_bound.append(None)
                s_sign.append(None)
                pinned = _andv(torch.logical_and(torch.logical_or(at_lo, at_hi), ~degen), i)
                sgn = torch.where(at_hi, one, -one)
                pin_val.append(T.mul(T.mul(T.where(pinned, 1.0, None, like=zero_like), sgn), cb))
            else:
                free.append(_andv(~(lam_m[i] <= tol_sc), i))
                fr_bound.append(None)
                s_sign.append(None)
                pin_val.append(None)
        Ffloat = [T.where(free[i], 1.0, None, like=zero_like) for i in range(D)]
        fbm = [
            T.mul(T.mul(T.where(fr_bound[i], 1.0, None, like=zero_like), s_sign[i]), mu_row[i])
            if is_fr[i] else None
            for i in range(D)
        ]

        # S = cfm M + J^T (I+B) F J  (nv x nv), built from sparse rows:
        # X[i] = F_i J_i + fbm_i F_n J_n; S += J_i^T X[i] summed over i
        S = [[T.mul(cfm, M[a][b_]) for b_ in range(nv)] for a in range(nv)]
        for i in range(D):
            Xi = {j: T.mul(Ffloat[i], el) for j, el in J_rows[i].items()}
            if is_fr[i]:
                nrm = fidx[i]
                for j, el in J_rows[nrm].items():
                    Xi[j] = T.add(Xi.get(j), T.mul(T.mul(fbm[i], Ffloat[nrm]), el))
            for a, ea in J_rows[i].items():
                for b_, xb in Xi.items():
                    S[a][b_] = T.add(S[a][b_], T.mul(ea, xb))
        # r = -F b; constant-box rows pinned at c_pin add cfm*c_pin:
        #   S u = J^T [(I+B) r + cfm c_pin],  S = cfm M + J^T (I+B) F J
        r = [T.mul(Ffloat[i], T.neg(b_vec[i])) for i in range(D)]
        IBr = []
        for i in range(D):
            t = r[i]
            if is_fr[i]:
                t = T.add(t, T.mul(fbm[i], r[fidx[i]]))
            if pin_val[i] is not None:
                t = T.add(t, T.mul(cfm, pin_val[i]))
            IBr.append(t)
        rhs_u = [None] * nv
        for i in range(D):
            if IBr[i] is None:
                continue
            for j, el in J_rows[i].items():
                rhs_u[j] = T.fma(rhs_u[j], el, IBr[i])
        # S is unsymmetric when friction-bound coupling is active: GE
        u = T.solve_ge(S, rhs_u)
        # x = (r - F J u) / cfm on the free set
        x = [T.mul(Ffloat[i], T.div(T.sub(r[i], T.mul(Ffloat[i], _sparse_dot(J_rows[i], u))), cfm))
             for i in range(D)]
        lam_new = []
        for i in range(D):
            t = x[i]
            if is_fr[i]:
                t = T.add(t, T.mul(fbm[i], x[fidx[i]]))
            if pin_val[i] is not None:
                t = T.add(t, pin_val[i])  # at-bound box rows sit at +-c
            lam_new.append(t)
        return [clip_row(i, lam_new[i], lam_new) for i in range(D)]

    def nat_residual(lam_m):
        """Natural-map residual per env."""
        w = matvec(lam_m)
        res = None
        for i in range(D):
            proj = clip_row(i, T.sub(lam_m[i], T.add(w[i], b_vec[i])), lam_m)
            res = T.maximum(res, T.abs_(T.sub(lam_m[i], proj)))
        return T.materialize(res, zero_like)

    def all_finite(xs):
        ok = xs[0] == xs[0]
        for x in xs:
            ok = torch.logical_and(ok, torch.isfinite(x))
        return ok

    # ---- guarded polish passes (primal only, all detached): iterate from
    # the last pass result, fall back on non-finite, keep the best iterate
    # by natural residual
    lam_it = [T.materialize(_sg(x), zero_like) for x in lam]
    best = lam_it
    best_res = nat_residual(best)
    for _ in range(passes):
        cand = [T.materialize(_sg(x), zero_like) for x in one_pass(lam_it)]
        finite = all_finite(cand)
        lam_it = [torch.where(finite, c, p) for c, p in zip(cand, lam_it)]
        res = nat_residual(lam_it)
        better = res < best_res
        best = [torch.where(better, c, b_) for c, b_ in zip(lam_it, best)]
        best_res = torch.minimum(res, best_res)

    # ---- gradient attachment (straight-through IFT): the value is exactly
    # `best`; the tangent comes from one more one_pass AT best, whose KKT
    # solve linearizes to the implicit-function-theorem gradient. A probe
    # pass (detached) finds the envs where that pass misbehaves; they keep
    # the value and get a zero tangent, and the differentiable pass runs on
    # sanitized inputs there so no NaN reaches the backward pass.
    if not torch.is_grad_enabled():
        return best
    probe = [T.materialize(x, zero_like) for x in one_pass(best)]
    finite = all_finite(probe)
    drift = None
    for g, b_ in zip(probe, best):
        g_clean = torch.where(torch.isfinite(g), g, _big(g))
        drift = T.maximum(drift, torch.abs(g_clean - b_))
    ok = torch.logical_and(finite, T.materialize(drift, zero_like) <= (best_res + 1.0) * 1e-5)
    safe_in = [torch.where(ok, b_, zero_like) for b_ in best]
    out_g = [T.materialize(x, zero_like) for x in one_pass(safe_in)]
    return [torch.where(ok, b_ + (g - g.detach()), b_) for g, b_ in zip(out_g, best)]


def _big(like):
    return torch.full_like(like, 1e30)
