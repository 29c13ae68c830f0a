# Frozen copy of diffdart_tpu_torch/ops/tile.py, the benchmark's plain reference; imports
# rewritten to portbench.reference. Later changes to the program do not reach it.
"""Element algebra over batched env vectors.

Counterpart of diffdart_tpu/ops/tile.py. There a live element is one (8, 128)
lane tile; here it is a (B,) tensor holding one scalar of every env, the
structure-of-arrays layout of the fused step (sim/tilestep.py,
ops/fused_step.py). Small vectors and matrices of the physics are Python
lists of elements, and all small-dimension indexing happens in Python, so
every torch op is a full-batch elementwise op.

Elements are one of:
  * None          -- structural zero (skipped entirely),
  * python float  -- constant (folded in float64 in Python, exactly as the
                     JAX version folds it),
  * torch.Tensor  -- a live (B,) element.

An op between a live element and a Python float computes in the live
element's dtype. Where an op has no live operand to take the dtype from
(`where` with two constant branches, `materialize`), the caller passes
`like`, and the result carries `like`'s dtype and device explicitly.

Gradient conventions follow jax.lax: maximum/minimum split the gradient
evenly at ties (torch.maximum/minimum do the same), abs has zero gradient at
0, and a/b divides with one rounding (Tensor.__rtruediv__ would take a
reciprocal first, so constant numerators go through `torch.div`).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _c(v, like):
    """0-d constant in `like`'s dtype and on its device."""
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def is_zero(a) -> bool:
    return a is None or (isinstance(a, (int, float)) and a == 0.0)


def is_const(a) -> bool:
    return a is None or isinstance(a, (int, float))


def add(a, b):
    if is_zero(a):
        return None if is_zero(b) else b
    if is_zero(b):
        return a
    if is_const(a) and is_const(b):
        return float(a) + float(b)
    if is_const(a):
        return b + float(a)
    if is_const(b):
        return a + float(b)
    return a + b


def sub(a, b):
    if is_zero(b):
        return None if is_zero(a) else a
    if is_zero(a):
        return neg(b)
    if is_const(a) and is_const(b):
        return float(a) - float(b)
    if is_const(a):
        return float(a) - b
    if is_const(b):
        return a - float(b)
    return a - b


def neg(a):
    if is_zero(a):
        return None
    if is_const(a):
        return -float(a)
    return -a


def mul(a, b):
    if is_zero(a) or is_zero(b):
        return None
    if is_const(a) and is_const(b):
        return float(a) * float(b)
    if is_const(a):
        return b if float(a) == 1.0 else b * float(a)
    if is_const(b):
        return a if float(b) == 1.0 else a * float(b)
    return a * b


def fma(acc, a, b):
    return add(acc, mul(a, b))


def div(a, b):
    if is_zero(a):
        return None
    if is_const(a) and is_const(b):
        return float(a) / float(b)
    if is_const(a):
        return torch.div(_c(a, b), b)
    if is_const(b):
        # a 0-d tensor, not a Python number: for a Python-number divisor
        # torch on CUDA multiplies by its reciprocal, which rounds
        # differently from the kernel's (and the CPU's) true division
        return torch.div(a, _c(b, a))
    return a / b


def rsqrt(a):
    if is_const(a):
        return 1.0 / float(a) ** 0.5
    return torch.rsqrt(a)


def sqrt(a):
    if is_zero(a):
        return None
    if is_const(a):
        return float(a) ** 0.5
    return torch.sqrt(a)


def maximum(a, b):
    # None (structural zero) is coerced BEFORE the const-const fold
    aa = 0.0 if a is None else a
    bb = 0.0 if b is None else b
    if is_const(aa) and is_const(bb):
        return max(float(aa), float(bb))
    if is_const(aa):
        return torch.maximum(bb, _c(aa, bb))
    if is_const(bb):
        return torch.maximum(aa, _c(bb, aa))
    return torch.maximum(aa, bb)


def minimum(a, b):
    aa = 0.0 if a is None else a
    bb = 0.0 if b is None else b
    if is_const(aa) and is_const(bb):
        return min(float(aa), float(bb))
    if is_const(aa):
        return torch.minimum(bb, _c(aa, bb))
    if is_const(bb):
        return torch.minimum(aa, _c(bb, aa))
    return torch.minimum(aa, bb)


def where(c, a, b, like=None):
    """c ? a : b for a bool element c. With two constant branches the
    result's dtype comes from `like`, which is then required."""
    aa = 0.0 if a is None else a
    bb = 0.0 if b is None else b
    if is_const(aa) and is_const(bb):
        if like is None:
            raise ValueError("where: two constant branches need `like` for their dtype")
        return torch.where(c, _c(aa, like), _c(bb, like))
    if is_const(aa):
        aa = _c(aa, bb)
    elif is_const(bb):
        bb = _c(bb, aa)
    return torch.where(c, aa, bb)


def materialize(a, like):
    """Force an element to a real (B,) tensor (for outputs)."""
    if a is None:
        return torch.zeros_like(like)
    if is_const(a):
        return torch.full_like(like, float(a))
    return a


def abs_(a):
    if is_zero(a):
        return None
    if is_const(a):
        return abs(float(a))
    return torch.abs(a)


def clip(x, lo, hi):
    """minimum(maximum(x, lo), hi)."""
    return minimum(maximum(x, lo), hi)


def gt0(a, like):
    """a > 0 as a bool element (None/const materialized against `like`)."""
    return materialize(a, like) > 0.0


# ---------------------------------------------------------------------------
# small linear algebra over element lists
# ---------------------------------------------------------------------------


def dot(xs, ys):
    """Sum_k xs[k]*ys[k], skipping structural zeros."""
    acc = None
    for x, y in zip(xs, ys):
        acc = fma(acc, x, y)
    return acc


def vadd(xs, ys):
    return [add(x, y) for x, y in zip(xs, ys)]


def vsub(xs, ys):
    return [sub(x, y) for x, y in zip(xs, ys)]


def vscale(xs, s):
    return [mul(x, s) for x in xs]


def cross3(a, b):
    return [
        sub(mul(a[1], b[2]), mul(a[2], b[1])),
        sub(mul(a[2], b[0]), mul(a[0], b[2])),
        sub(mul(a[0], b[1]), mul(a[1], b[0])),
    ]


def matvec3(R, x):
    """R: 3x3 nested list, x: len-3 list."""
    return [dot(R[i], x) for i in range(3)]


def matTvec3(R, x):
    return [dot([R[0][i], R[1][i], R[2][i]], x) for i in range(3)]


def matmul3(A, B):
    return [[dot(A[i], [B[0][j], B[1][j], B[2][j]]) for j in range(3)] for i in range(3)]


def transpose3(A):
    return [[A[j][i] for j in range(3)] for i in range(3)]


def eye3():
    return [[1.0, None, None], [None, 1.0, None], [None, None, 1.0]]


def tf_compose_t(Ra, pa, Rb, pb):
    """(Ra, pa) o (Rb, pb): R = Ra Rb, p = Ra pb + pa."""
    return matmul3(Ra, Rb), vadd(matvec3(Ra, pb), pa)


def exp_so3_const_axis(axis, theta):
    """Rodrigues for a CONSTANT unit axis (python floats) and a live angle:
    R = I + sin t [a]x + (1 - cos t) [a]x^2, entries folded where axis
    components are zero."""
    ax, ay, az = (float(a) for a in axis)
    if is_const(theta):
        # the JAX version evaluates a constant angle in float32
        s = float(np.sin(np.float32(theta or 0.0)))
        c = float(np.cos(np.float32(theta or 0.0)))
    else:
        s, c = torch.sin(theta), torch.cos(theta)
    one_m_c = sub(1.0, c)
    K = [[None, -az or None, ay or None], [az or None, None, -ax or None], [-ay or None, ax or None, None]]
    # K2 = a a^T - I (for unit axis)
    a = [ax, ay, az]
    K2 = [[mul(a[i], a[j]) if i != j else add(mul(a[i], a[j]), -1.0) for j in range(3)] for i in range(3)]
    return [
        [
            add(add(1.0 if i == j else None, mul(s, K[i][j])), mul(one_m_c, K2[i][j]))
            for j in range(3)
        ]
        for i in range(3)
    ]


def chol_factor(M):
    """Unrolled Cholesky of a small SPD element matrix (nested lists)."""
    n = len(M)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[i][j]
            for k in range(j):
                s = sub(s, mul(L[i][k], L[j][k]))
            if i == j:
                L[i][i] = sqrt(maximum(s, 1e-12))
            else:
                L[i][j] = div(s, L[j][j]) if s is not None else None
    return L


def chol_solve(L, b):
    """Solve (L L^T) x = b given a chol_factor result."""
    n = len(b)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = sub(s, mul(L[i][k], y[k]))
        y[i] = div(s, L[i][i]) if s is not None else None
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = sub(s, mul(L[k][i], x[k]))
        x[i] = div(s, L[i][i]) if s is not None else None
    return x


def solve_spd(M, b):
    """Solve M x = b for a small SPD element matrix by unrolled Cholesky."""
    return chol_solve(chol_factor(M), b)


def safe_div(num, den):
    """num/den with dead denominators (|den| <= 1e-20) contributing ZERO
    instead of inf in float32, so singular systems yield finite garbage that
    the callers' guards discard. float64 keeps a plain division."""
    if is_zero(num):
        return None
    if is_const(den):
        return div(num, den) if abs(float(den)) > 1e-20 else None
    if den.dtype == torch.float64:
        return div(num, den)
    dead = torch.abs(den) <= 1e-20
    return torch.where(dead, _c(0.0, den), div(num, torch.where(dead, _c(1.0, den), den)))


def solve_ge(M, b):
    """Solve M x = b by Gaussian elimination WITHOUT pivoting, unrolled.
    For the diagonally regularized, possibly unsymmetric active-set KKT
    matrix S = cfm M + J^T (I+B) F J."""
    n = len(b)
    A = [[M[i][j] for j in range(n)] for i in range(n)]
    x = list(b)
    for k in range(n - 1):
        for i in range(k + 1, n):
            if is_zero(A[i][k]):
                continue
            f = safe_div(A[i][k], A[k][k])
            for j in range(k + 1, n):
                A[i][j] = sub(A[i][j], mul(f, A[k][j]))
            x[i] = sub(x[i], mul(f, x[k]))
    out = [None] * n
    for i in reversed(range(n)):
        s = x[i]
        for j in range(i + 1, n):
            s = sub(s, mul(A[i][j], out[j]))
        out[i] = safe_div(s, A[i][i])
    return out


_EPS = 1e-8  # small-angle threshold of the quaternion exponential


def quat_normalize_t(q):
    """q: list of 4 elements -> normalized."""
    inv = rsqrt(dot(q, q))
    return [mul(x, inv) for x in q]


def quat_to_mat_t(q):
    """Unit quaternion (list of 4 elements) -> 3x3 nested-list rotation."""
    w, x, y, z = q
    xx, yy, zz = mul(x, x), mul(y, y), mul(z, z)
    xy, xz, yz = mul(x, y), mul(x, z), mul(y, z)
    wx, wy, wz = mul(w, x), mul(w, y), mul(w, z)
    two = 2.0
    return [
        [sub(1.0, mul(two, add(yy, zz))), mul(two, sub(xy, wz)), mul(two, add(xz, wy))],
        [mul(two, add(xy, wz)), sub(1.0, mul(two, add(xx, zz))), mul(two, sub(yz, wx))],
        [mul(two, sub(xz, wy)), mul(two, add(yz, wx)), sub(1.0, mul(two, add(xx, yy)))],
    ]


def _cos_sqrt_t(t2):
    """cos(sqrt(t2)) with a Taylor branch near 0 (safe gradient)."""
    if is_const(t2):
        t2 = float(t2 or 0.0)
        return 1.0 - t2 / 2.0 + t2 * t2 / 24.0 if t2 < _EPS else math.cos(math.sqrt(t2))
    small = t2 < _EPS
    safe = torch.where(small, torch.ones_like(t2), t2)
    return torch.where(small, add(sub(1.0, div(t2, 2.0)), div(mul(t2, t2), 24.0)),
                       torch.cos(torch.sqrt(safe)))


def _sinc_t2_t(t2):
    """sin(sqrt(t2))/sqrt(t2) with a Taylor branch near 0."""
    if is_const(t2):
        t2 = float(t2 or 0.0)
        if t2 < _EPS:
            return 1.0 - t2 / 6.0 + t2 * t2 / 120.0
        return math.sin(math.sqrt(t2)) / math.sqrt(t2)
    small = t2 < _EPS
    safe = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    return torch.where(small, add(sub(1.0, div(t2, 6.0)), div(mul(t2, t2), 120.0)),
                       torch.sin(safe) / safe)


def quat_exp_t(v):
    """R^3 (list of 3 elements) -> unit quaternion, half-angle convention."""
    h2 = mul(0.25, dot(v, v))
    if h2 is None:
        return [1.0, None, None, None]
    w = _cos_sqrt_t(h2)
    s = mul(0.5, _sinc_t2_t(h2))
    return [w] + [mul(s, x) for x in v]


def quat_mul_t(a, b):
    """Hamilton product of two quaternion element lists."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return [
        sub(sub(mul(aw, bw), mul(ax, bx)), add(mul(ay, by), mul(az, bz))),
        sub(add(add(mul(aw, bx), mul(ax, bw)), mul(ay, bz)), mul(az, by)),
        add(sub(mul(aw, by), mul(ax, bz)), add(mul(ay, bw), mul(az, bx))),
        add(add(mul(aw, bz), mul(ax, by)), sub(mul(az, bw), mul(ay, bx))),
    ]


def spatial_transform_motion(R, p, w, v):
    """World-origin Plucker coordinates of a child-frame motion vector
    (w, v): w_w = R w; v_w = R v + p x (R w)."""
    ww = matvec3(R, w)
    vv = vadd(matvec3(R, v), cross3(p, ww))
    return ww, vv
