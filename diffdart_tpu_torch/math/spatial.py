"""Spatial (6-D) vector algebra in Plucker coordinates, batched.

Counterpart of diffdart_tpu/math/spatial.py, with the same conventions:
angular-first motion V = (omega, v) and force F = (n, f); a transform (R, p)
maps body to world coordinates; X = [[R, 0], [skew(p) R, R]] maps motion
vectors and X^-T force vectors; world quantities are Plucker coordinates at
the world origin.
"""
from __future__ import annotations

import torch

from diffdart_tpu_torch.math.lie import _mv, cross, skew


def motion_cross(v, m):
    """crm(v) @ m: spatial cross product of motion vectors (..., 6)."""
    w, u = v[..., :3], v[..., 3:]
    mw, mu = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, mw), cross(w, mu) + cross(u, mw)], dim=-1)


def force_cross(v, f):
    """crf(v) @ f = -crm(v)^T @ f: motion vector v acting on force vector f."""
    w, u = v[..., :3], v[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(u, fl), cross(w, fl)], dim=-1)


def transform_motion(R, p, V):
    """V_world = X(R, p) @ V_body for motion vectors (the Adjoint map)."""
    Rw = _mv(R, V[..., :3])
    Ru = _mv(R, V[..., 3:])
    return torch.cat([Rw, cross(p, Rw) + Ru], dim=-1)


def inv_transform_motion(R, p, V):
    """V_body = X(R, p)^-1 @ V_world."""
    w, u = V[..., :3], V[..., 3:]
    Rt = R.transpose(-1, -2)
    return torch.cat([_mv(Rt, w), _mv(Rt, u - cross(p, w))], dim=-1)


def transform_force(R, p, F):
    """F_world = X(R, p)^-T @ F_body for force vectors."""
    Rf = _mv(R, F[..., 3:])
    Rn = _mv(R, F[..., :3])
    return torch.cat([Rn + cross(p, Rf), Rf], dim=-1)


def X_motion(R, p):
    """Dense (..., 6, 6) motion transform matrix [[R, 0], [skew(p) R, R]]."""
    pR = skew(p) @ R
    R = R.expand(pR.shape)
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    return torch.cat([top, torch.cat([pR, R], dim=-1)], dim=-2)


def spatial_inertia(mass, com, inertia):
    """Body-frame 6x6 spatial inertia about the body origin (angular-first).
    mass (...,), com (..., 3) in the body frame, inertia (..., 3, 3) about
    the COM; their leading axes broadcast (e.g. a per-env mass (B, nbody)
    with a shared com (nbody, 3))."""
    c = skew(com)
    ct = c.transpose(-1, -2)
    m = mass[..., None, None]
    eye = _eye3(c)
    blocks = torch.broadcast_tensors(inertia + m * (c @ ct), m * c, m * ct, m * eye)
    top = torch.cat(blocks[:2], dim=-1)
    bot = torch.cat(blocks[2:], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def transform_inertia(R, p, I_body):
    """World-origin Plucker coordinates of a body-frame spatial inertia:
    I_world = X^-T I_body X^-1."""
    Xinv = _X_motion_inverse(R, p)
    return Xinv.transpose(-1, -2) @ I_body @ Xinv


def _X_motion_inverse(R, p):
    """X(R, p)^-1 = [[R^T, 0], [-R^T skew(p), R^T]]."""
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, torch.zeros_like(Rt)], dim=-1)
    bot = torch.cat([-Rt @ skew(p), Rt], dim=-1)
    return torch.cat([top, bot], dim=-2)
