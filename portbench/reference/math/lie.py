# Frozen copy of diffdart_tpu_torch/math/lie.py, the benchmark's plain reference; imports
# rewritten to portbench.reference. Later changes to the program do not reach it.
"""SO(3)/SE(3) Lie-group operations, batched and differentiable.

Counterpart of diffdart_tpu/math/lie.py. Every function broadcasts over
leading axes; small-angle branches are Taylor series selected with
torch.where on a function of t2 = theta^2 (smooth in the input), with the
other branch's denominator poisoned to 1, so gradients stay finite at zero.

Quaternions are (w, x, y, z). Transforms are (R, p) pairs with
x_world = R @ x_body + p.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _mv(R, x):
    """Batched matrix-vector product (..., 3, 3) x (..., 3) -> (..., 3)."""
    return (R @ x.unsqueeze(-1)).squeeze(-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def skew(v):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix: skew(a) @ b = a x b."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _sinc_t2(t2):
    """sin(sqrt(t2))/sqrt(t2), Taylor-safe at 0 (finite value and gradient)."""
    small = t2 < _EPS
    safe = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    return torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, torch.sin(safe) / safe)


def _cosc_t2(t2):
    """(1 - cos(sqrt(t2)))/t2, Taylor-safe at 0."""
    small = t2 < _EPS
    safe = torch.where(small, torch.ones_like(t2), t2)
    return torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                       (1.0 - torch.cos(torch.sqrt(safe))) / safe)


def _sinc3_t2(t2):
    """(sqrt(t2) - sin(sqrt(t2)))/t2^1.5, Taylor-safe at 0."""
    small = t2 < _EPS
    safe = torch.where(small, torch.ones_like(t2), t2)
    st = torch.sqrt(safe)
    return torch.where(small, 1.0 / 6.0 - t2 / 120.0, (st - torch.sin(st)) / (st * safe))


def _cos_sqrt(t2):
    """cos(sqrt(t2)), Taylor-safe gradient at 0."""
    small = t2 < _EPS
    safe = torch.where(small, torch.ones_like(t2), t2)
    return torch.where(small, 1.0 - t2 / 2.0 + t2 * t2 / 24.0, torch.cos(torch.sqrt(safe)))


def _sinc(theta):
    return _sinc_t2(theta * theta)


def _cosc(theta):
    return _cosc_t2(theta * theta)


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w):
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    t2 = torch.sum(w * w, dim=-1)
    W = skew(w)
    W2 = W @ W
    a = _sinc_t2(t2)[..., None, None]
    b = _cosc_t2(t2)[..., None, None]
    return _eye_like(W) + a * W + b * W2


def log_so3(R):
    """(..., 3, 3) rotation matrix -> (..., 3) axis-angle (theta in [0, pi])."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    vee = 0.5 * torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    near_pi = theta > math.pi - 1e-4
    factor = torch.where(_sinc(theta) < _EPS, torch.ones_like(theta), 1.0 / _sinc(theta))
    generic = vee * factor[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag - cos_t[..., None]) / torch.clamp(1.0 - cos_t[..., None], min=_EPS),
                          0.0, 1.0)
    axis = torch.sqrt(axis_sq)
    s_xy = R[..., 0, 1] + R[..., 1, 0]
    s_xz = R[..., 0, 2] + R[..., 2, 0]
    sign_x = torch.where(vee[..., 0] < 0, -1.0, 1.0).to(R.dtype)
    sx = axis[..., 0] * sign_x
    sy = torch.where(s_xy * sx < 0, -axis[..., 1], axis[..., 1])
    sz = torch.where(s_xz * sx < 0, -axis[..., 2], axis[..., 2])
    near = torch.stack([sx, sy, sz], dim=-1) * theta[..., None]
    return torch.where(near_pi[..., None], near, generic)


def exp_se3(xi):
    """se(3) exp map: (..., 6) twist (omega, v) -> transform (R, p)."""
    w, v = xi[..., :3], xi[..., 3:]
    t2 = torch.sum(w * w, dim=-1)
    W = skew(w)
    W2 = W @ W
    eye = _eye_like(W)
    R = eye + _sinc_t2(t2)[..., None, None] * W + _cosc_t2(t2)[..., None, None] * W2
    V = eye + _cosc_t2(t2)[..., None, None] * W + _sinc3_t2(t2)[..., None, None] * W2
    return R, _mv(V, v)


def log_se3(R, p):
    """Inverse of exp_se3: transform (R, p) -> (..., 6) twist (omega, v)."""
    w = log_so3(R)
    t2 = torch.sum(w * w, dim=-1)
    W = skew(w)
    W2 = W @ W
    small = t2 < _EPS
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    coef = torch.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        (1.0 - _sinc_t2(safe_t2) / (2.0 * _cosc_t2(safe_t2))) / safe_t2,
    )
    Vinv = _eye_like(W) - 0.5 * W + coef[..., None, None] * W2
    return torch.cat([w, _mv(Vinv, p)], dim=-1)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_conj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q, v):
    """Rotate vector v by quaternion q (same as quat_to_mat(q) @ v)."""
    qw, qv = q[..., :1], q[..., 1:]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def mat_to_quat(R):
    """Branchless Shepperd method: (..., 3, 3) -> (..., 4) unit quaternion."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                          1.0 - m00 - m11 + m22], dim=-1)
    case = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 cases, 4)
    idx = case[..., None, None].expand(*case.shape, 1, 4)
    q = quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])
    return torch.where(q[..., :1] < 0, -q, q)


def quat_exp(v):
    """Exponential map R^3 -> unit quaternion (half-angle convention):
    quat_to_mat(quat_exp(w)) == exp_so3(w)."""
    h2 = 0.25 * torch.sum(v * v, dim=-1)
    w = _cos_sqrt(h2)[..., None]
    xyz = 0.5 * _sinc_t2(h2)[..., None] * v
    return torch.cat([w, xyz], dim=-1)


def quat_log(q):
    """Inverse of quat_exp: unit quaternion -> R^3 axis-angle, NaN-safe
    gradient at the identity (the small branch is a function of |xyz|^2)."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    xyz = q[..., 1:]
    n2 = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    small = n2 < _EPS
    norm = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    half = torch.atan2(norm, w)
    w_safe = torch.clamp(w, min=0.5)
    taylor = 2.0 / w_safe - 2.0 * n2 / (3.0 * w_safe**3)
    scale = torch.where(small, taylor, 2.0 * half / norm)
    return scale * xyz


# ---------------------------------------------------------------------------
# Rigid transforms as (R, p) pairs
# ---------------------------------------------------------------------------


def tf_identity(dtype=torch.float32, batch=(), device=None):
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch, 3, 3)
    return R, torch.zeros(*batch, 3, dtype=dtype, device=device)


def tf_compose(Ra, pa, Rb, pb):
    """(Ra, pa) o (Rb, pb): first apply b, then a."""
    return Ra @ Rb, _mv(Ra, pb) + pa


def tf_inverse(R, p):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, p)


def tf_apply(R, p, x):
    return _mv(R, x) + p
