"""Checkpoint and resume with torch.save / torch.load.

Counterpart of diffdart_tpu/utils/checkpoint.py. A tree of tensors, numbers,
strings, dicts, lists, tuples and States (parameters, an optimizer's
`state_dict()`, env states, a `torch.Generator`'s `get_state()`) is saved
with its tensors on the host and States as plain dicts, and loaded with
`weights_only=True`, so a checkpoint file cannot run code. `like`, a tree
of the saved structure, gives the States and each tensor's device back.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from diffdart_tpu_torch.dynamics.model import State


def _to_plain(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, State):
        return {f.name: _to_plain(getattr(tree, f.name)) for f in dataclasses.fields(State)}
    if isinstance(tree, dict):
        return {k: _to_plain(x) for k, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_plain(x) for x in tree)
    return tree


def _like(tree, like):
    if isinstance(like, torch.Tensor):
        return tree.to(like.device)
    if isinstance(like, State):
        return State(**{f.name: _like(tree[f.name], getattr(like, f.name))
                        for f in dataclasses.fields(State)})
    if isinstance(like, dict):
        return {k: _like(x, like[k]) if k in like else x for k, x in tree.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_like(x, y) for x, y in zip(tree, like))
    return tree


def save_checkpoint(path: str, tree, step: int | None = None) -> str:
    """Save `tree` to `path` (with `step`: to `path/step_{step}.pt`) and
    return the file written. The file is written beside its target and
    renamed over it, so a crash leaves the old checkpoint or the new one."""
    path = os.path.abspath(path)
    fname = os.path.join(path, f"step_{step}.pt") if step is not None else path
    os.makedirs(os.path.dirname(fname), exist_ok=True)
    tmp = f"{fname}.tmp{os.getpid()}"
    torch.save(_to_plain(tree), tmp)
    os.replace(tmp, fname)
    return fname


def restore_checkpoint(path: str, like=None):
    """Load a checkpoint written by save_checkpoint: tensors on the host and
    States as dicts, or, given `like`, in its structure and on its
    tensors' devices."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return tree if like is None else _like(tree, like)
