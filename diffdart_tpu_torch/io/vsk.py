"""Vicon Skeleton (.vsk) parser -> ModelBuilder (host side, run once at
build time). Counterpart of diffdart_tpu/io/vsk.py, on xml.etree and numpy.

The motion-capture subset: <Parameters> substitution, the <Skeleton>
segment tree (JointFree / JointBall / JointHinge / JointHardDof), inertia
defaults per segment scaled by its bounding size, and the <MarkerSet>
(marker name -> (segment, local offset)) used to retarget mocap data.

VSK files are written in millimetres; positions are converted to metres.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from diffdart_tpu_torch.dynamics.model import JointType

_MM = 1e-3


def _parse_params(root) -> dict:
    params = {}
    for p in root.iter("Parameter"):
        name = p.get("NAME")
        try:
            params[name] = float(p.get("VALUE", "0"))
        except (TypeError, ValueError):
            pass
    return params


def _value(tok: str, params: dict) -> float:
    """One VSK numeric token: a literal, a parameter name, or 'PARAM*k'."""
    tok = tok.strip()
    try:
        return float(tok)
    except ValueError:
        pass
    if "*" in tok:
        a, b = tok.split("*", 1)
        return _value(a, params) * _value(b, params)
    if tok in params:
        return params[tok]
    raise ValueError(f"unresolvable VSK value {tok!r}")


def _vec3(s: str | None, params: dict, scale=_MM) -> np.ndarray:
    if not s:
        return np.zeros(3)
    return np.array([_value(t, params) for t in s.split()[:3]], float) * scale


_JOINT_TAGS = {
    "JointFree": JointType.FREE,
    "JointBall": JointType.BALL,
    "JointHinge": JointType.REVOLUTE,
    "JointHardDof": JointType.WELD,
    "JointDummy": JointType.WELD,
}


def parse_vsk(path_or_str: str) -> dict:
    """Parse a .vsk into {'params', 'segments', 'markers'}.

    segments: list of dicts (name, parent (name or None), jtype, offset (3,),
    axis (3,)) in tree order; markers: {name: (segment, offset (3,))}.
    """
    if os.path.exists(path_or_str):
        root = ET.parse(path_or_str).getroot()
    else:
        root = ET.fromstring(path_or_str)
    params = _parse_params(root)

    segments = []

    def walk(el, parent_name):
        for child in el:
            if child.tag != "Segment":
                continue
            name = child.get("NAME")
            jtype = JointType.BALL  # VSK default: ball-jointed mocap segment
            offset = _vec3(child.get("POSITION"), params)
            axis = np.array([0.0, 0.0, 1.0])
            for j_el in child:
                if j_el.tag in _JOINT_TAGS:
                    jtype = _JOINT_TAGS[j_el.tag]
                    if j_el.get("POSITION"):
                        offset = _vec3(j_el.get("POSITION"), params)
                    if j_el.get("AXIS"):
                        axis = _vec3(j_el.get("AXIS"), params, scale=1.0)
                        n = np.linalg.norm(axis)
                        axis = axis / n if n > 0 else np.array([0.0, 0.0, 1.0])
                    break
            bounds = _vec3(child.get("BOUNDS"), params) if child.get("BOUNDS") else None
            segments.append(
                dict(name=name, parent=parent_name, jtype=jtype, offset=offset, axis=axis,
                     bounds=bounds)
            )
            walk(child, name)

    skel = root.find("Skeleton")
    if skel is None:
        raise ValueError("no <Skeleton> in VSK")
    walk(skel, None)

    markers = {}
    for mk in root.iter("Marker"):
        seg = mk.get("SEGMENT")
        markers[mk.get("NAME")] = (seg, _vec3(mk.get("POSITION"), params))
    return dict(params=params, segments=segments, markers=markers)


def load_vsk_into_builder(builder, path_or_str: str, default_mass: float = 1.0):
    """Emit the VSK segment tree into a ModelBuilder. Returns
    {'body_index': {segment: idx}, 'markers': {name: (body_idx, offset)}}.

    Mocap skeletons carry no mass data; segments get `default_mass` with a
    bound-box inertia (the reference applies similar defaults)."""
    vsk = parse_vsk(path_or_str)
    body_index = {}
    for seg in vsk["segments"]:
        parent = body_index.get(seg["parent"], -1)
        size = seg["bounds"] if seg["bounds"] is not None else np.full(3, 0.05)
        hx, hy, hz = np.maximum(np.abs(size), 1e-3)
        inertia = default_mass / 3.0 * np.diag([hy**2 + hz**2, hx**2 + hz**2, hx**2 + hy**2])
        idx = builder.add_body(
            parent=parent,
            jtype=seg["jtype"],
            X_pos=seg["offset"],
            axis=seg["axis"],
            mass=default_mass,
            inertia=inertia,
            name=seg["name"],
        )
        body_index[seg["name"]] = idx
    markers = {
        name: (body_index[segname], off)
        for name, (segname, off) in vsk["markers"].items()
        if segname in body_index
    }
    return dict(body_index=body_index, markers=markers)
