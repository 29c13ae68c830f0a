"""Data parallelism over the env axis. Counterpart of diffdart_tpu/parallel/:
the mesh and data-parallel gradients (comm.py) and the torch.distributed
process group (distributed.py)."""
from diffdart_tpu_torch.parallel.comm import data_parallel_grad, make_mesh, shard_batch  # noqa: F401
from diffdart_tpu_torch.parallel.distributed import (  # noqa: F401
    global_mesh,
    init_distributed,
    local_env_slice,
    make_global_batch,
    shutdown_distributed,
)
