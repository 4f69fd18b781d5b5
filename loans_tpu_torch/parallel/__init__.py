"""Data-parallel training over processes, one per GPU (counterpart of
``loans_tpu.parallel``): the process group, replication, batch sharding
and the explicit collectives. ``python -m loans_tpu_torch.parallel.dryrun``
runs one alternating step over N processes (on the GPUs, or with
``--device cpu`` on the CPU)."""

from loans_tpu_torch.parallel.distributed import (
    bind_device,
    broadcast_object,
    data_parallel_rank,
    data_parallel_size,
    init_distributed,
    is_main,
    local_batch_slice,
    local_rank,
    process_group,
    rank,
    shutdown,
    suspended,
    world_size,
)
from loans_tpu_torch.parallel.mesh import (
    all_reduce_gradients,
    global_batch_norm,
    global_sum,
    local_rows,
    reduce_metrics,
    replicate,
    shard_batch,
)

__all__ = [
    "all_reduce_gradients",
    "bind_device",
    "broadcast_object",
    "data_parallel_rank",
    "data_parallel_size",
    "global_batch_norm",
    "global_sum",
    "init_distributed",
    "is_main",
    "local_batch_slice",
    "local_rank",
    "local_rows",
    "process_group",
    "rank",
    "reduce_metrics",
    "replicate",
    "shard_batch",
    "shutdown",
    "suspended",
    "world_size",
]
