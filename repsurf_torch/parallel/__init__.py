"""Data parallelism (repsurf_tpu/parallel): process groups, batch padding
and per-rank slices, and the data-parallel train steps
(``parallel.shard_step``, imported on use)."""

from .distributed import (
    all_reduce_sum,
    free_port,
    init_distributed,
    is_main_process,
    local_batch_size,
    process_info,
    shutdown,
    spawn,
)
from .mesh import pad_to_multiple, shard_batch, shard_rows

__all__ = [
    "all_reduce_sum",
    "free_port",
    "init_distributed",
    "is_main_process",
    "local_batch_size",
    "pad_to_multiple",
    "process_info",
    "shard_batch",
    "shard_rows",
    "shutdown",
    "spawn",
]
