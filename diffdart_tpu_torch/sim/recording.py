"""Trajectory recordings: save and load (.npz) and golden-trajectory
checks. Counterpart of diffdart_tpu/sim/recording.py.

A recording is the trajectory State of sim/step.py::rollout, its fields
stacked over time: (T, nq) for one env, (T, B, nq) for a batch. A golden
is one env's (T, nq) / (T, nv) trajectory; compare_to_golden holds every
env of a batched trajectory to it.
"""
from __future__ import annotations

import numpy as np
import torch

from diffdart_tpu_torch.dynamics.model import State, resolve_device


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_recording(path: str, traj: State, meta: dict | None = None):
    """Write traj's q, v and t (zeros over the first axis when t is None)
    and meta's entries (as meta_<key>) to a compressed .npz; returns path."""
    q = _np(traj.q)
    np.savez_compressed(
        path,
        q=q,
        v=_np(traj.v),
        t=_np(traj.t) if traj.t is not None else np.zeros(len(q)),
        **{f"meta_{k}": v for k, v in (meta or {}).items()},
    )
    return path


def load_recording(path: str, device="cuda", dtype=None) -> State:
    """The recording at `path` as a State of tensors on `device`, in `dtype`
    (default: the stored dtype)."""
    data = np.load(path)
    dev = resolve_device(device)
    return State(*(torch.as_tensor(data[k], dtype=dtype, device=dev) for k in ("q", "v", "t")))


def compare_to_golden(traj: State, golden_path: str, q_tol=1e-6, v_tol=1e-6) -> dict:
    """The largest deviation of traj from the stored golden, over every step
    and, for a (T, B, ...) trajectory, every env: {"max_dq", "max_dv",
    "q_ok", "v_ok"}, and for a batch "env_dq", "env_dv", each env's largest
    deviation (numpy (B,)). Callers assert on them."""
    g = np.load(golden_path)
    q, v = _np(traj.q), _np(traj.v)
    if q.ndim == 3:
        gq, gv = g["q"][:, None], g["v"][:, None]
        env_dq = np.abs(q - gq).max(axis=(0, 2))
        env_dv = np.abs(v - gv).max(axis=(0, 2))
        dq, dv = float(env_dq.max()), float(env_dv.max())
        extra = {"env_dq": env_dq, "env_dv": env_dv}
    else:
        dq = float(np.max(np.abs(q - g["q"])))
        dv = float(np.max(np.abs(v - g["v"])))
        extra = {}
    return {"max_dq": dq, "max_dv": dv, "q_ok": dq <= q_tol, "v_ok": dv <= v_tol, **extra}
