"""Differentiable primitive narrowphase, batched over leading axes.

Counterpart of diffdart_tpu/collision/narrowphase.py for the pairs the
half-cheetah, the worm and cube_drop use: sphere, capsule and box against a
plane. Every pair returns a fixed number k of candidate contacts with a
validity mask: pos (..., k, 3), normal (..., k, 3), depth (..., k), valid
(..., k). The normal pushes geom A away from geom B; depth > 0 means
penetrating. Sizes: sphere (r, -, -); box half-extents; capsule (r,
half_len, -) along the geom z axis; a plane's normal is its geom z axis.
The other pairs are ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

import torch

from diffdart_tpu_torch.math.lie import _mv


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _stack(outs):
    return tuple(torch.stack([o[i] for o in outs], dim=-2 if i < 2 else -1) for i in range(4))


def sphere_plane(Ra, pa, sa, Rb, pb, sb):
    """A = sphere, B = plane (normal = B's z axis)."""
    r = sa[..., 0]
    n = Rb[..., :, 2]
    depth = r - _dot(pa - pb, n)
    pos = pa - n * (r - 0.5 * depth).unsqueeze(-1)
    return _stack([(pos, n, depth, depth > 0)])


def capsule_plane(Ra, pa, sa, Rb, pb, sb):
    """A = capsule, B = plane: 2 candidate contacts at the end spheres."""
    r, hl = sa[..., 0], sa[..., 1]
    axis = Ra[..., :, 2]
    n = Rb[..., :, 2]
    outs = []
    for s in (-1.0, 1.0):
        c = pa + axis * (s * hl).unsqueeze(-1)
        depth = r - _dot(c - pb, n)
        pos = c - n * (r - 0.5 * depth).unsqueeze(-1)
        outs.append((pos, n, depth, depth > 0))
    return _stack(outs)


def box_plane(Ra, pa, sa, Rb, pb, sb):
    """A = box, B = plane: all 8 corners are candidate contacts."""
    n = Rb[..., :, 2]
    outs = []
    for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
            for sz in (-1.0, 1.0):
                corner_local = sa * torch.tensor([sx, sy, sz], dtype=sa.dtype, device=sa.device)
                c = _mv(Ra, corner_local) + pa
                depth = -_dot(c - pb, n)
                outs.append((c + 0.5 * depth.unsqueeze(-1) * n, n, depth, depth > 0))
    return _stack(outs)
