"""Offline trajectory export: a standalone HTML replay file.

Counterpart of diffdart_tpu/viewer/export.py: a whole rollout (positions
on any device) becomes a single self-contained .html anyone can open."""
from __future__ import annotations

import json

from diffdart_tpu_torch.viewer.client import build_page
from diffdart_tpu_torch.viewer.protocol import scene_description, trajectory_frames


def save_html(model, qs, path, stride=4, dt=None):
    """Write a standalone replay page for a (T, nq) position trajectory."""
    scene = scene_description(model)
    frames = trajectory_frames(model, qs, dt=dt, stride=stride)
    html = build_page(json.dumps(scene), json.dumps(frames), "null")
    with open(path, "w") as f:
        f.write(html)
    return path
