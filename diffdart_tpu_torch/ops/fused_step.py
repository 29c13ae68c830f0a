"""Fused timestep on the structure-of-arrays layout: the Hopper kernels
(ops/csrc/fused_step.cu: the step and its VJP) on CUDA tensors, their plain
PyTorch version (sim/tilestep.py, and autograd through it) on CPU tensors.

Counterpart of diffdart_tpu/ops/pallas_step.py. The TPU lays envs out as
(nq|nv, 8, L) lane tiles and needs B % 1024 == 0; here a state is (nq, B) /
(nv, B) with one env per column, any B, and `to_soa` / `from_soa` replace
`to_tiles` / `from_tiles`.

Gradients: on CUDA, a call with grad enabled and an input that requires
grad goes through FusedStepFn, whose backward is the VJP kernel (port of
`_bwd_kernel`, in the same .cu: reverse mode on a tape that each env's
thread records, sized once per model and dtype by a counting launch); on
the CPU autograd runs through the plain version. The kernels cover the
plain version's subset (REVOLUTE / PRISMATIC / PLANAR / WELD / FREE / BALL
joints; capsule / sphere / box / convex-hull vs fixed-plane contacts, a
hull's 4 deepest vertices as its slots; joint-limit, servo and
joint-friction rows) within the size caps below, but not its hybrid LCP
(kernel_unsupported_reason); a CUDA call for a model outside that raises
NotImplementedError; rollout_tiled
runs a model in the hybrid LCP mode through the plain version on either
device, as the JAX package does.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref

import numpy as np
import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from diffdart_tpu_torch.dynamics.model import JointType, Model, State
from diffdart_tpu_torch.ops import _build
from diffdart_tpu_torch.sim.tilestep import (
    SLOTS,
    _np,
    _tangent_basis_const,
    build_tile_step,
    check_supported,
    contact_plan,
    dof_qidx,
    lcp_mode,
    lcp_rows,
)

# size caps compiled into the kernel (fused_step.cu); checked at load time
MAX_NB, MAX_NQ, MAX_NV, MAX_PAIRS, MAX_NC, MAX_LIM, MAX_D = 16, 16, 16, 16, 32, 16, 64
MAX_HULL_VERTS = 64  # the pool of hull vertices, over every convex pair
# bytes of one tape node (Node<S>: two int32 operand indices, two partials)
# and of its adjoint, per dtype; checked at load time
NODE_BYTES = {torch.float32: 16, torch.float64: 24}

# descriptor layouts, in the field order of DescI / DescF<T>
_I_LAYOUT = [
    ("hdr", 11), ("parent", MAX_NB), ("jtype", MAX_NB), ("q_off", MAX_NB), ("v_off", MAX_NB),
    ("anc", MAX_NB * MAX_NV), ("dof_body", MAX_NV), ("dof_qidx", MAX_NV),
    ("pair_body", MAX_PAIRS), ("pair_type", MAX_PAIRS), ("pair_vert_off", MAX_PAIRS),
    ("pair_nvert", MAX_PAIRS), ("lim_dof", MAX_LIM),
    ("servo_dof", MAX_NV), ("fric_dof", MAX_NV),
]
_F_LAYOUT = [
    ("X_rot", MAX_NB * 9), ("X_pos", MAX_NB * 3), ("axis", MAX_NB * 3), ("axis2", MAX_NB * 3),
    ("rot_ax", MAX_NB * 3), ("rot_K", MAX_NB * 9), ("rot_K2", MAX_NB * 9),
    ("mass", MAX_NB), ("com", MAX_NB * 3), ("inertia", MAX_NB * 9),
    ("damping", MAX_NV), ("m_extra", MAX_NV), ("spring", MAX_NV), ("q_rest", MAX_NV),
    ("lim_lo", MAX_LIM), ("lim_hi", MAX_LIM), ("neg_grav", 3), ("scalars", 3),
    ("pair_rot", MAX_PAIRS * 9), ("pair_pos", MAX_PAIRS * 3), ("pair_size", MAX_PAIRS * 3),
    ("pair_n", MAX_PAIRS * 3), ("pair_p", MAX_PAIRS * 3), ("pair_t1", MAX_PAIRS * 3),
    ("pair_t2", MAX_PAIRS * 3), ("pair_mu", MAX_PAIRS), ("pair_rest", MAX_PAIRS),
    ("pair_off", MAX_PAIRS), ("hull_verts", MAX_HULL_VERTS * 3),
    ("servo_tgt", MAX_NV), ("box_c", 2 * MAX_NV),
]


def _flat(layout, fields, dtype):
    parts = []
    for name, n in layout:
        a = np.zeros(n, dtype)
        src = np.asarray(fields.get(name, ()), dtype).ravel()
        a[: src.size] = src
        parts.append(a)
    return np.concatenate(parts)


def kernel_unsupported_reason(model: Model) -> str | None:
    """Why the CUDA kernel cannot run `model` (None if it can). Models
    outside the plain version's subset raise TileStepUnsupported from
    build_tile_step first. The part of the subset that the kernel lacks
    comes first, the hybrid LCP; then the size caps, among them the pool of
    hull vertices that the convex pairs share."""
    plan = contact_plan(model)
    if lcp_mode(model) == "xla":
        return ("the hybrid LCP runs outside the kernel (more than 64 LCP rows, or a contact "
                "budget below the slot count)")
    if any(p["body"] < 0 for p in plan):
        return "contact pairs on a static (world) geom are not supported"
    nc = sum(SLOTS[p["gtype"]] for p in plan)
    nlim = len(model.limited_dofs) if model.enable_joint_limits else 0
    caps = [("bodies", model.nbody, MAX_NB), ("nq", model.nq, MAX_NQ), ("nv", model.nv, MAX_NV),
            ("contact pairs", len(plan), MAX_PAIRS), ("contact slots", nc, MAX_NC),
            ("limited dofs", nlim, MAX_LIM), ("LCP rows", lcp_rows(model, nc), MAX_D),
            ("hull vertices", sum(len(p.get("verts", ())) for p in plan), MAX_HULL_VERTS)]
    for what, n, cap in caps:
        if n > cap:
            return f"{what} = {n} exceeds the kernel's cap of {cap}"
    return None


def pack_descriptor(model: Model):
    """The kernel's model descriptor: (int32 array in DescI order, float64
    array in DescF order; cast to the state dtype on upload). Derived
    constants are computed in float64, as the plain version folds them.
    Raises NotImplementedError for models outside the kernel's subset."""
    check_supported(model)
    reason = kernel_unsupported_reason(model)
    if reason:
        raise NotImplementedError(f"fused_step kernel: {reason}")
    nb, nv = model.nbody, model.nv
    plan = contact_plan(model)
    nc = sum(SLOTS[p["gtype"]] for p in plan)
    lim = [int(d) for d in model.limited_dofs] if model.enable_joint_limits else []
    D = lcp_rows(model, nc)
    axis, axis2 = _np(model.axis), _np(model.axis2)
    rot_ax = np.zeros((nb, 3))
    for i, j in enumerate(model.jtype):
        if j == JointType.REVOLUTE:
            rot_ax[i] = axis[i]
        elif j == JointType.PLANAR:
            rot_ax[i] = np.cross(axis[i], axis2[i])
    rot_K = np.stack([np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]) for a in rot_ax])
    rot_K2 = np.stack([np.outer(a, a) - np.eye(3) for a in rot_ax])
    dt = float(model.dt)
    damping, armature, spring = _np(model.damping), _np(model.armature), _np(model.spring_stiff)
    q_lo, q_hi = _np(model.q_lo), _np(model.q_hi)
    qidx = dof_qidx(model)
    anc = np.zeros((MAX_NB, MAX_NV))
    anc[:nb, :nv] = model.ancestor_mask
    servo, fric = [int(d) for d in model.servo_dofs], [int(d) for d in model.friction_dofs]
    ints = dict(
        hdr=[nb, model.nq, nv, len(plan), nc, len(lim), len(servo), len(fric), D,
             int(model.contact_iters), 2 if model.lcp_polish else 0],
        parent=model.parent, jtype=model.jtype, q_off=model.q_off, v_off=model.v_off,
        anc=anc, dof_body=model.dof_body,
        dof_qidx=[-1 if x is None else x for x in qidx],
        pair_body=[p["body"] for p in plan], pair_type=[p["gtype"] for p in plan],
        lim_dof=lim, servo_dof=servo, fric_dof=fric,
    )
    tangents = [_tangent_basis_const(p["n"]) for p in plan]
    nvert = [len(p.get("verts", ())) for p in plan]
    ints.update(pair_vert_off=np.cumsum([0] + nvert[:-1]), pair_nvert=nvert)
    hulls = [p["verts"] for p in plan if "verts" in p]
    floats = dict(
        X_rot=_np(model.X_rot), X_pos=_np(model.X_pos), axis=axis, axis2=axis2,
        rot_ax=rot_ax, rot_K=rot_K, rot_K2=rot_K2,
        mass=_np(model.mass), com=_np(model.com), inertia=_np(model.inertia),
        damping=damping, m_extra=armature + dt * damping + dt * dt * spring,
        spring=spring, q_rest=_np(model.q_rest),
        lim_lo=q_lo[lim], lim_hi=q_hi[lim], neg_grav=-_np(model.gravity),
        scalars=[dt, float(model.contact_cfm), float(model.baumgarte_erp) / dt],
        pair_rot=[p["grot"] for p in plan], pair_pos=[p["gpos"] for p in plan],
        pair_size=[p["size"] for p in plan], pair_n=[p["n"] for p in plan],
        pair_p=[p["p_pl"] for p in plan], pair_t1=[t[0] for t in tangents],
        pair_t2=[t[1] for t in tangents], pair_mu=[p["friction"] for p in plan],
        pair_rest=[p["restitution"] for p in plan],
        # the depth's offset p_pl . n, folded in float64 as the plain version folds it
        pair_off=[float(np.dot(p["p_pl"], p["n"])) if "verts" in p else 0.0 for p in plan],
        hull_verts=np.concatenate(hulls) if hulls else (),
        servo_tgt=_np(model.servo_target)[servo],
        box_c=np.concatenate([_np(model.force_limit)[servo] * dt, _np(model.joint_friction)[fric] * dt]),
    )
    return _flat(_I_LAYOUT, ints, np.int32), _flat(_F_LAYOUT, floats, np.float64)


@functools.lru_cache(maxsize=None)
def _load(kind: str) -> ctypes.CDLL:
    """The built fused_step library with its functions' argtypes declared
    and its descriptor layout checked against the packer's."""
    lib = _build.build("fused_step", kind)
    lib.fused_step_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.fused_step_layout.restype = None
    for name in ("fused_step_f32", "fused_step_f64"):
        _build.declare(getattr(lib, name), 7, 4)
    lib.fused_step_occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.fused_step_occupancy.restype = ctypes.c_int
    for name in ("fused_step_vjp_f32", "fused_step_vjp_f64"):
        _build.declare(getattr(lib, name), 14, 2)
    want = [sum(n for _, n in _I_LAYOUT), sum(n for _, n in _F_LAYOUT), sum(n for _, n in _F_LAYOUT),
            MAX_NB, MAX_NQ, MAX_NV, MAX_PAIRS, MAX_NC, MAX_LIM, MAX_D,
            NODE_BYTES[torch.float32], NODE_BYTES[torch.float64], MAX_HULL_VERTS]
    buf = (ctypes.c_int * len(want))()
    # [DescI ints, DescF<float>, DescF<double>, the caps, Node<float>, Node<double>,
    #  the hull vertex cap]
    lib.fused_step_layout(buf)
    got = list(buf)
    if got != want:
        raise RuntimeError(f"fused_step descriptor layout mismatch: kernel {got}, packer {want}")
    return lib


def _ptr(x):
    return None if x is None else x.data_ptr()


def occupancy(kind: str, dtype, D: int, nv: int) -> dict:
    """The step kernel's footprint for a model of D LCP rows and nv dofs:
    shared memory per env (one warp, one block) and, on the card
    (kind='cuda'), the warps that fit on one SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor; 0 in the host build)."""
    out = (ctypes.c_int * 2)()
    err = _load(kind).fused_step_occupancy(torch.finfo(dtype).bits // 8, D, nv, out)
    if err:
        raise RuntimeError(f"fused_step occupancy query failed: CUDA error {err}")
    return dict(zip(("env_bytes", "warps_per_sm"), out))


class _FusedStepKernel:
    """Wrapper of the CUDA kernel (one warp per env). `launches` counts
    kernel launches, and nothing else."""

    name = "fused_step"

    def __init__(self):
        self.launches = 0

    def __call__(self, desc_i, desc_f, q, v, tau, D):
        """D: the descriptor's LCP rows (they size the shared memory)."""
        lib = _load("cuda")
        fn = lib.fused_step_f32 if q.dtype == torch.float32 else lib.fused_step_f64
        qo = torch.empty_like(q)
        vo = torch.empty_like(v)
        B = q.shape[1]
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(desc_i.data_ptr(), desc_f.data_ptr(), q.data_ptr(), v.data_ptr(),
                     tau.data_ptr(), qo.data_ptr(), vo.data_ptr(), B, D, v.shape[0], 0, stream)
        if err:
            raise RuntimeError(f"fused_step kernel launch failed: CUDA error {err}")
        self.launches += 1
        return qo, vo


def tape_bytes(dtype, cap: int, B: int) -> int:
    """Bytes of the VJP kernel's tape: cap nodes and their adjoints per env."""
    return cap * B * (NODE_BYTES[dtype] + torch.finfo(dtype).bits // 8)


def tape_capacity(nodes: int) -> int:
    """Tape capacity for a model whose envs record `nodes` nodes. Every env
    of a model records the same number (fused_step.cu, the node kinds); the
    margin covers an env whose state is not finite, where a constant's value
    may change a fold. An env that still needs more makes the launch raise."""
    return nodes + nodes // 16 + 256


def check_tape(status, cap: int):
    """Raise if a VJP launch that wrote `status` (a (2,) int32 tensor: the
    largest node count of an env, the overflow flag) overflowed a tape of
    `cap` nodes per env. Reading it waits for the launch."""
    need, over = status.tolist()
    if over:
        raise RuntimeError(f"fused_step_vjp: tape overflow: an env records {need} nodes, the "
                           f"tape holds {cap}")


class TapeStatus:
    """The overflow status that the VJP launches of one backward pass
    share: each launch writes it, and one check_tape at the end of the pass
    reads it, so the host waits for the card once per pass rather than
    after every launch."""

    def __init__(self):
        self.tensor, self.cap = None, 0

    def take(self, device, cap: int):
        """The status tensor for the next launch (zeroed at the first launch
        of a pass)."""
        if self.tensor is None:
            self.tensor = torch.zeros(2, dtype=torch.int32, device=device)
        self.cap = cap
        return self.tensor

    def check(self):
        """check_tape on what the pass's launches wrote; the next pass starts
        from zero."""
        status, self.tensor = self.tensor, None
        if status is not None:
            check_tape(status, self.cap)


class _FusedStepVjpKernel:
    """Wrapper of the VJP kernel: (dq, dv, dtau) = (gq, gv) . d(q', v') /
    d(q, v, tau), one thread per env, each recording its step on a tape of
    `cap` nodes (tape_capacity) and sweeping it in reverse. With
    primal=True it also returns the step (q', v') that the recording
    computed. `status`, a zeroed (2,) int32 tensor that several launches may
    share, receives the overflow status, which the caller then checks
    (check_tape); without it the call checks its own, which waits for the
    launch. `launches` counts launches that record and sweep, and nothing
    else; `count_launches` the launches that only count nodes (tape_nodes,
    once per model and dtype)."""

    name = "fused_step_vjp"

    def __init__(self):
        self.launches = 0
        self.count_launches = 0

    @staticmethod
    def _fn(dtype):
        lib = _load("cuda")
        return lib.fused_step_vjp_f32 if dtype == torch.float32 else lib.fused_step_vjp_f64

    def tape_nodes(self, desc_i, desc_f, q, v, tau):
        """Nodes that one env of this model records: a launch over the first
        env that counts and writes nothing else."""
        one = [x[:, :1].contiguous() for x in (q, v, tau)]
        status = torch.zeros(2, dtype=torch.int32, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = self._fn(q.dtype)(*(_ptr(x) for x in (desc_i, desc_f, *one)), *([None] * 8),
                                    status.data_ptr(), 1, 0, stream)
        if err:
            raise RuntimeError(f"fused_step_vjp counting launch failed: CUDA error {err}")
        self.count_launches += 1
        return int(status[0].item())

    def __call__(self, desc_i, desc_f, q, v, tau, gq, gv, cap, primal=False, status=None):
        for g, x, name in ((gq, q, "gq"), (gv, v, "gv")):
            if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device or not g.is_contiguous():
                raise ValueError(f"fused_step_vjp: {name} must be a contiguous {x.dtype} tensor of "
                                 f"shape {tuple(x.shape)} on {x.device}")
        fn = self._fn(q.dtype)
        dq, dv, dtau = torch.empty_like(q), torch.empty_like(v), torch.empty_like(tau)
        qo, vo = (torch.empty_like(q), torch.empty_like(v)) if primal else (None, None)
        B = q.shape[1]
        tape = torch.empty(tape_bytes(q.dtype, cap, B), dtype=torch.uint8, device=q.device)
        own = status is None
        if own:
            status = torch.zeros(2, dtype=torch.int32, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(*(_ptr(x) for x in (desc_i, desc_f, q, v, tau, gq, gv, dq, dv, dtau, qo, vo,
                                         tape, status)), B, cap, stream)
        if err:
            raise RuntimeError(f"fused_step_vjp kernel launch failed: CUDA error {err}")
        self.launches += 1
        if own:
            check_tape(status, cap)
        return (dq, dv, dtau, qo, vo) if primal else (dq, dv, dtau)


KERNEL = _FusedStepKernel()
VJP_KERNEL = _FusedStepVjpKernel()


class FusedStepFn(torch.autograd.Function):
    """(q', v') = step(q, v, tau) with the step's VJP as its backward, the
    counterpart of the JAX package's custom_vjp (ops/pallas_step.py:101-114):
    the forward launches the step and saves (q, v, tau); the backward
    launches the VJP, which recomputes the step. `launch(q, v, tau)` and
    `launch_vjp(q, v, tau, gq, gv)` are the two launchers (FusedStep passes
    the CUDA kernels)."""

    @staticmethod
    def forward(ctx, launch, launch_vjp, q, v, tau):
        ctx.launch_vjp = launch_vjp
        ctx.save_for_backward(q, v, tau)
        return launch(q, v, tau)

    @staticmethod
    @once_differentiable
    def backward(ctx, gq, gv):
        q, v, tau = ctx.saved_tensors
        return (None, None, *ctx.launch_vjp(q, v, tau, gq.contiguous(), gv.contiguous()))


class FusedStep:
    """step(q, v, tau) -> (q', v') on SoA tensors (nq, B), (nv, B), (nv, B)
    for one model. CPU tensors run the plain version (differentiable by
    autograd); CUDA tensors launch the kernel, through FusedStepFn when an
    input requires grad, or raise. Holds no reference to the model, so a
    cached FusedStep does not keep its model alive."""

    def __init__(self, model: Model):
        self.nq, self.nv = model.nq, model.nv
        self.plain = build_tile_step(model, output="stacked")
        self.unsupported_reason = kernel_unsupported_reason(model)  # None: the kernels run it
        self._packed = None if self.unsupported_reason else pack_descriptor(model)
        self.D = None if self._packed is None else int(self._packed[0][8])  # LCP rows
        self._desc = {}  # (device, dtype) -> (DescI tensor, DescF tensor)
        self._tape = {}  # dtype -> the VJP kernel's tape capacity (nodes per env)

    def descriptor(self, device, dtype):
        if self.unsupported_reason:
            raise NotImplementedError(f"fused_step kernel: {self.unsupported_reason}")
        key = (str(device), dtype)
        if key not in self._desc:
            di, df = self._packed
            self._desc[key] = (torch.as_tensor(di, device=device),
                               torch.as_tensor(df, dtype=dtype, device=device))
        return self._desc[key]

    def _launch(self, q, v, tau):
        return KERNEL(*self.descriptor(q.device, q.dtype), q, v, tau, self.D)

    def tape_capacity(self, q, v, tau):
        """The VJP kernel's tape capacity for this model in q's dtype, from
        one counting launch (on the first env of q, v, tau), then cached."""
        if q.dtype not in self._tape:
            nodes = VJP_KERNEL.tape_nodes(*self.descriptor(q.device, q.dtype), q, v, tau)
            self._tape[q.dtype] = tape_capacity(nodes)
        return self._tape[q.dtype]

    def _launch_vjp(self, q, v, tau, gq, gv, status: TapeStatus, check: bool):
        cap = self.tape_capacity(q, v, tau)
        out = VJP_KERNEL(*self.descriptor(q.device, q.dtype), q, v, tau, gq, gv, cap,
                         status=status.take(q.device, cap))
        if check:
            status.check()
        return out

    def __call__(self, q, v, tau, status: TapeStatus | None = None, check: bool = True):
        """One step. `status` and `check` concern the backward pass on CUDA:
        the steps of a rollout share one TapeStatus, and only the first step
        (check=True), whose backward autograd runs last, reads it, so an
        overflow raises before any gradient leaves the rollout. Without a
        status the step's backward checks its own launch."""
        B = q.shape[-1]
        for x, k, name in ((q, self.nq, "q"), (v, self.nv, "v"), (tau, self.nv, "tau")):
            if x.shape != (k, B):
                raise ValueError(f"fused_step: {name} must be ({k}, B={B}), got {tuple(x.shape)}")
            if x.dtype not in (torch.float32, torch.float64) or x.dtype != q.dtype:
                raise TypeError(f"fused_step: {name} must be float32 or float64 like q, got {x.dtype}")
            if x.device != q.device:
                raise ValueError(f"fused_step: {name} is on {x.device}, q on {q.device}")
        if q.device.type == "cpu":
            return self.plain(q, v, tau)
        if q.device.type != "cuda":
            raise ValueError(f"fused_step: unsupported device {q.device}")
        q, v, tau = q.contiguous(), v.contiguous(), tau.contiguous()
        if torch.is_grad_enabled() and any(x.requires_grad for x in (q, v, tau)):
            if status is None:
                status, check = TapeStatus(), True
            vjp = functools.partial(self._launch_vjp, status=status, check=check)
            return FusedStepFn.apply(self._launch, vjp, q, v, tau)
        return self._launch(q, v, tau)


_STEPS = {}  # id(model) -> (weak reference to the model, tensor versions, its FusedStep)


def _forget(key, ref):
    if _STEPS.get(key, (None,))[0] is ref:
        del _STEPS[key]


def _versions(model: Model):
    """The version counters of the model's tensors: an in-place change to
    any of them bumps its counter."""
    return tuple(x._version for x in (getattr(model, f.name) for f in dataclasses.fields(model))
                 if isinstance(x, torch.Tensor))


def build_fused_step(model: Model) -> FusedStep:
    """The FusedStep of `model`, built once and kept, with its device
    descriptors, while the model lives: repeated rollouts skip the set-up.
    Keyed on the model object's identity (a Model holds tensors, so it
    cannot be a key by value) and held weakly, so a dropped model frees its
    entry; a tensor of the model changed in place rebuilds it. Raises
    TileStepUnsupported for models outside the fused subset."""
    key, versions = id(model), _versions(model)
    hit = _STEPS.get(key)
    if hit is not None and hit[0]() is model and hit[1] == versions:
        return hit[2]
    step = FusedStep(model)
    _STEPS[key] = (weakref.ref(model, functools.partial(_forget, key)), versions, step)
    return step


def host_kernel_step(model: Model, q, v, tau, dtype=torch.float64, front_only=False):
    """The step kernel's per-env code compiled for the host CPU (ops/_build.py,
    kind='host'), its warp's 32 lanes run in turn, on SoA tensors of
    `dtype`: (q', v'). front_only: the launch that stops after the front end,
    which returns (None, v*). Checks the kernel's arithmetic and its lane
    partition where there is no GPU. Not on any execution path."""
    lib = _load("host")
    fn = lib.fused_step_f32 if dtype == torch.float32 else lib.fused_step_f64
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    di, df = pack_descriptor(model)
    df = df.astype(np_dtype)
    q, v, tau = (np.ascontiguousarray(x.detach().cpu().numpy(), np_dtype) for x in (q, v, tau))
    qo, vo = np.empty_like(q), np.empty_like(v)
    ptr = [a.ctypes.data for a in (di, df, q, v, tau, qo, vo)]
    err = fn(*ptr, q.shape[1], int(di[8]), model.nv, int(front_only), None)
    if err:
        raise RuntimeError(f"host fused_step failed: {err}")
    return None if front_only else torch.from_numpy(qo), torch.from_numpy(vo)


def host_kernel_vjp(model: Model, q, v, tau, gq, gv, cap=None, dtype=torch.float64):
    """The VJP kernel's per-env code compiled for the host CPU, on SoA
    tensors of `dtype`: ((dq, dv, dtau), (q', v'), nodes), where (q', v') is
    the primal step of the recording and `nodes` the node count of the first
    env (a counting call). `cap` is the tape capacity in nodes (default:
    tape_capacity(nodes)); an env that needs more raises. Not on any
    execution path."""
    lib = _load("host")
    fn = lib.fused_step_vjp_f32 if dtype == torch.float32 else lib.fused_step_vjp_f64
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    di, df = pack_descriptor(model)
    df = df.astype(np_dtype)
    q, v, tau, gq, gv = (np.ascontiguousarray(x.detach().cpu().numpy(), np_dtype)
                         for x in (q, v, tau, gq, gv))
    B = q.shape[1]
    status = np.zeros(2, np.int32)
    one = [np.ascontiguousarray(x[:, :1]) for x in (q, v, tau)]
    err = fn(*(a.ctypes.data for a in (di, df, *one)), *([None] * 8), status.ctypes.data, 1, 0, None)
    if err:
        raise RuntimeError(f"host fused_step_vjp counting call failed: {err}")
    nodes = int(status[0])
    cap = tape_capacity(nodes) if cap is None else cap
    tape = np.empty(tape_bytes(dtype, cap, B), np.uint8)
    status[:] = 0
    outs = [np.empty_like(x) for x in (q, v, tau, q, v)]
    ptr = [a.ctypes.data for a in (di, df, q, v, tau, gq, gv, *outs, tape, status)]
    err = fn(*ptr, B, cap, None)
    if err:
        raise RuntimeError(f"host fused_step_vjp failed: {err}")
    if status[1]:
        raise RuntimeError(f"fused_step_vjp: tape overflow: an env records {int(status[0])} nodes, "
                           f"the tape holds {cap}")
    dq, dv, dtau, qo, vo = (torch.from_numpy(x) for x in outs)
    return (dq, dv, dtau), (qo, vo), nodes


def to_soa(x):
    """(B, k) -> (k, B), contiguous."""
    return x.transpose(-1, -2).contiguous()


def from_soa(x):
    """(k, B) -> (B, k)."""
    return x.transpose(-1, -2)


def make_bench_fns(model: Model):
    """(roll, grad) over SoA inputs ((nq, B), (nv, B), (T, nv, B)), as the
    JAX version's (ops/pallas_step.py:133-155): roll(q, v, taus) -> (qf, vf)
    is the forward rollout of the benchmark; grad(q, v, taus) -> dtaus is
    the gradient of its BPTT loss mean(qf[1]**2) + 1e-4 mean(taus**2) with
    respect to the control tape."""
    step = build_fused_step(model)

    def roll(q, v, taus):
        status = TapeStatus()  # read once per backward pass, by step 0's
        for t in range(taus.shape[0]):
            q, v = step(q, v, taus[t], status, check=t == 0)
        return q, v

    def loss(q, v, taus):
        qf, _ = roll(q, v, taus)
        return (qf[1] ** 2).mean() + 1e-4 * (taus**2).mean()

    def grad(q, v, taus):
        taus = taus.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(loss(q, v, taus), taus)[0]

    return roll, grad


def rollout_tiled(model: Model, state: State, taus) -> State:
    """Rollout on the fused path. state: batched State with (B, nq)/(B, nv)
    fields; taus: (T, B, nv). Returns the final batched State. Gradients
    flow wrt state and taus on both devices (model parameters are baked).

    A model in the hybrid LCP mode (lcp_mode(model) == 'xla': more than 64
    LCP rows, or a cutting contact budget) takes the hybrid branch on either
    device, as the JAX package's does: a loop over the plain version's step
    (sim/tilestep.py, output='tiles'), each step checkpointed, so the
    backward pass recomputes one step at a time. On the card that branch
    issues one small kernel per element op; sim/fast.py::rollout_fast sends
    such models to the vmap stack there instead. Any other model runs
    FusedStep: the plain version on CPU tensors; on CUDA tensors the
    kernels, or NotImplementedError naming kernel_unsupported_reason (a
    size cap)."""
    soa_q, soa_v = to_soa(state.q), to_soa(state.v)
    taus_soa = taus.transpose(1, 2).contiguous()
    if lcp_mode(model) == "xla":
        qf, vf = _rollout_hybrid(model, soa_q, soa_v, taus_soa)
    else:
        roll, _ = make_bench_fns(model)
        qf, vf = roll(soa_q, soa_v, taus_soa)
    t = state.t + taus.shape[0] * float(model.dt) if state.t is not None else None
    return State(q=from_soa(qf), v=from_soa(vf), t=t)


def _rollout_hybrid(model: Model, q, v, taus):
    """The hybrid branch on SoA tensors: T checkpointed steps of the plain
    version (in its hybrid LCP mode, which 'auto' picks for the models that
    take this branch); (qf, vf)."""
    tstep = build_tile_step(model, output="tiles")
    nq = model.nq

    def one(*xs):
        qn, vn = tstep(xs[:nq], xs[nq:nq + model.nv], xs[nq + model.nv:])
        return (*qn, *vn)

    qt, vt = tuple(q), tuple(v)
    for t in range(taus.shape[0]):
        out = checkpoint(one, *qt, *vt, *taus[t], use_reentrant=False)
        qt, vt = out[:nq], out[nq:]
    return torch.stack(qt), torch.stack(vt)
