"""Multi-process runtime on torch.distributed.

Counterpart of diffdart_tpu/parallel/distributed.py. Every process runs the
same program; `init_distributed` forms the process group, each process
feeds its rows of the env axis (`local_env_slice`, `make_global_batch`),
and parallel/comm.py::data_parallel_grad all-reduces the loss and gradient
sums across the group. Nothing above this module knows how many processes
exist.

Launch: under torchrun (`torchrun --nproc-per-node=N train.py`) call
`init_distributed()` with no arguments; it reads MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK and LOCAL_RANK. Or pass the coordinator's "host:port",
the process count and this process's index. The backend is NCCL, on the
card (`LOCAL_RANK`, else the process index modulo the card count, picks
this process's card); the caller may ask for gloo instead, as the CPU tests
do. No backend is ever chosen in place of another: a failed NCCL init
raises.

Single-process mode (nothing configured) is a first-class path: every
function below works on the local devices with process count 1.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from diffdart_tpu_torch.parallel.comm import ENV_AXIS, Mesh, ShardedBatch, _split


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None) -> bool:
    """Form (or join) the process group. Returns True once a group is up,
    False when nothing is configured (the single-process local run).
    Idempotent: a second call with a group up returns True.

    backend None means "nccl", which needs CUDA (RuntimeError otherwise);
    pass backend="gloo" for a CPU group."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed: the coordinator address, the process count and "
                         "the process index must all be given (or all come from MASTER_ADDR/"
                         "MASTER_PORT, WORLD_SIZE and RANK)")
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: the NCCL backend needs a CUDA device; pass "
                               "backend='gloo' for a CPU process group")
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def shutdown_distributed() -> None:
    """Tear down the process group (end of job / between tests)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _local_device() -> torch.device:
    """This process's device: its card under NCCL or with no group, the
    CPU under gloo."""
    if dist.is_initialized() and dist.get_backend() != "nccl":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("global_mesh: no CUDA device is available; initialize a gloo group "
                           "or pass devices= explicitly")
    return torch.device("cuda", torch.cuda.current_device())


def global_mesh(axis: str = ENV_AXIS, devices=None) -> Mesh:
    """1-D mesh with one entry per process, in rank order, each its local
    device (gathered from every process: all must call this), or over an
    explicit `devices` list."""
    if devices is None:
        if dist.is_initialized():
            names = [None] * dist.get_world_size()
            dist.all_gather_object(names, str(_local_device()))
            devices = names
        else:
            devices = [_local_device()]
    return Mesh(tuple(torch.device(d) for d in devices), axis)


def local_env_slice(global_batch_size: int) -> slice:
    """The slice of the global env axis this process feeds (a uniform
    split; global_batch_size must divide evenly)."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} must divide the {n}-process cluster")
    per = global_batch_size // n
    i = process_index()
    return slice(i * per, (i + 1) * per)


def make_global_batch(mesh: Mesh, local_tree) -> ShardedBatch:
    """This process's rows of a global env-sharded batch.

    local_tree: a tree of tensors or numpy arrays holding this process's
    rows of the env axis, (B_local, ...). The mesh's devices are split into
    one contiguous group per process, in rank order, and the rows are
    sharded over this process's group. data_parallel_grad all-reduces the
    env count with the sums, so the mean is over every process's rows. In
    a single process this is shard_batch."""
    n, i = process_count(), process_index()
    if mesh.size % n:
        raise ValueError(f"make_global_batch: a mesh of {mesh.size} devices does not split "
                         f"over {n} processes")
    per = mesh.size // n
    devices = mesh.devices[i * per:(i + 1) * per]
    return ShardedBatch(_split(local_tree, devices), devices)
