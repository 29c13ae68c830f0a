"""Device mesh and data-parallel gradients: everything above this module is
topology-agnostic.

Counterpart of diffdart_tpu/parallel/comm.py. The one scaling axis is the
environment (batch) axis: a batch is split into contiguous shards along its
leading axis, one per mesh device, the replicated parameters are copied to
every device, and the per-shard gradients are summed (JAX's psum). Where a
torch.distributed process group is up, the sums are also all-reduced
across processes (NCCL on the card, gloo where the caller asks for it; see
parallel/distributed.py). There is no global array in torch: a batch is a
`ShardedBatch`, this process's shards; the env count over all processes
travels in the all-reduce with the sums.

One process drives at most one card. Its mesh may repeat a device (a host
mesh of CPU devices, as the tests use), but a mesh over two cards in one
process raises: data_parallel_grad evaluates a process's shards one after
another, since each shard's backward pass ends with a host sync (the VJP
tape's overflow status). Several cards run as one process each, under
torchrun, with `init_distributed()` and `global_mesh()`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from diffdart_tpu_torch.dynamics.model import State

ENV_AXIS = "env"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: `devices` in order along its one axis."""

    devices: tuple
    axis: str = ENV_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class ShardedBatch:
    """This process's part of a batch split along its leading env axis:
    `shards[i]` (a tree of the batch's structure) lives on `devices[i]`."""

    shards: tuple
    devices: tuple


def tree_map(fn, tree):
    """fn applied to every tensor and numpy array of a tree of dicts, lists,
    tuples and States; other leaves are kept as they are."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, State):
        return State(**{f.name: tree_map(fn, getattr(tree, f.name))
                        for f in dataclasses.fields(State)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, x) for k, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return tree


def make_mesh(n_devices: int | None = None, axis: str = ENV_AXIS, devices=None) -> Mesh:
    """1-D mesh over the CUDA devices this process sees (or the first n),
    or over an explicit `devices` list (e.g. ``[torch.device("cpu")] * 8``
    for a host mesh).

    Raises ValueError if fewer devices exist than requested (truncating
    would validate nothing) or if the mesh spans two cards (one process
    drives one card: see the module's docstring), and RuntimeError for a
    CUDA mesh on a machine with no GPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass "
                               "devices=[torch.device('cpu')] * n for a host mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"make_mesh: requested {n_devices} devices but only {len(devs)} "
                             f"are available ({[str(d) for d in devs]})")
        devs = devs[:n_devices]
    _one_card(devs, "make_mesh")
    return Mesh(tuple(devs), axis)


def _one_card(devices, who: str) -> None:
    """ValueError if `devices` (one process's) name two CUDA devices."""
    cards = sorted({str(d) for d in devices if torch.device(d).type == "cuda"})
    if len(cards) > 1:
        raise ValueError(f"{who}: one process drives one card, got {cards}; its shards would run "
                         f"one after another. Start one process per card (torchrun "
                         f"--nproc-per-node=N), call init_distributed() and use global_mesh()")


def _split(tree, devices):
    """Contiguous shards of `tree` along its leading axis, shard i on
    devices[i] (this process's devices)."""
    _one_card(devices, "shard_batch")
    leaves = []
    tree_map(leaves.append, tree)
    if not leaves:
        raise ValueError("shard_batch: the batch holds no tensor")
    n = leaves[0].shape[0]
    k = len(devices)
    if any(x.shape[0] != n for x in leaves):
        raise ValueError(f"shard_batch: leading axes differ: {[tuple(x.shape) for x in leaves]}")
    if n % k:
        raise ValueError(f"shard_batch: {n} envs do not split evenly over {k} devices")
    per = n // k
    return tuple(tree_map(lambda x: torch.as_tensor(x[i * per:(i + 1) * per]).to(dev), tree)
                 for i, dev in enumerate(devices))


def shard_batch(mesh: Mesh, tree) -> ShardedBatch:
    """Split a batched tree (leading env axis) over the mesh: one contiguous
    shard per device, placed on it."""
    return ShardedBatch(_split(tree, mesh.devices), mesh.devices)


def _param_list(params):
    if isinstance(params, dict):
        return list(params.values())
    return [params]


def _like_params(params, flat):
    if isinstance(params, dict):
        return dict(zip(params.keys(), flat))
    return flat[0]


def data_parallel_grad(loss_fn, mesh: Mesh):
    """Build step(params, batch) -> (loss, grad) for loss_fn(params, batch),
    which returns a per-env loss of shape (B,).

    `batch` is a ShardedBatch (shard_batch, make_global_batch) or a batched
    tree, which is sharded over the mesh first; `params` (a tensor or a dict
    of tensors) is replicated. Each shard's loss sum and gradient are
    computed on its device, then summed in shard order on the params'
    device; with a process group up, the loss sum, gradient sum and env
    count are all-reduced across processes. The division by the global env
    count comes last, so one process with one shard does the unsharded
    arithmetic: loss = mean of the per-env losses, grad its gradient."""

    def step(params, batch):
        if not isinstance(batch, ShardedBatch):
            batch = shard_batch(mesh, batch)
        plist = _param_list(params)
        home = plist[0].device
        loss_sum, grad_sum, count = None, None, 0
        for shard, dev in zip(batch.shards, batch.devices):
            local = [p.detach().to(dev).requires_grad_(True) for p in plist]
            per_env = loss_fn(_like_params(params, local), shard)
            s = per_env.sum()
            grads = torch.autograd.grad(s, local)
            s, grads = s.detach().to(home), [g.to(home) for g in grads]
            loss_sum = s if loss_sum is None else loss_sum + s
            grad_sum = grads if grad_sum is None else [a + b for a, b in zip(grad_sum, grads)]
            count += per_env.shape[0]
        if dist.is_available() and dist.is_initialized():
            flat = torch.cat([loss_sum.reshape(1), *(g.reshape(-1) for g in grad_sum),
                              torch.tensor([float(count)], dtype=loss_sum.dtype, device=home)])
            dist.all_reduce(flat)
            loss_sum = flat[0]
            sizes = [g.numel() for g in grad_sum]
            grad_sum = [x.view_as(g) for x, g in zip(flat[1:-1].split(sizes), grad_sum)]
            count = int(flat[-1].item())
        return loss_sum / count, _like_params(params, [g / count for g in grad_sum])

    return step
