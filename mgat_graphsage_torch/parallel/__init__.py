"""Multi-GPU training of the port: the mesh (``mesh.py``) and the
process-group runtime with its collectives (``distributed.py``)."""

from .distributed import (
    all_reduce_gradients,
    all_reduce_sum,
    batch_shard,
    batch_sum,
    copy_to_group,
    current_batch_shard,
    gather_columns,
    global_batch_from_local,
    host_row_slice,
    initialize_distributed,
    is_distributed,
)
from .mesh import (
    Mesh,
    data_parallel_specs,
    gather_rows,
    make_mesh,
    param_shardings,
    replicate,
    shard_batch,
    shard_rows,
    shard_state,
)

__all__ = [
    "data_parallel_specs", "make_mesh", "replicate", "shard_batch",
    "initialize_distributed", "is_distributed", "host_row_slice",
    "global_batch_from_local", "param_shardings", "shard_state",
    "Mesh", "shard_rows", "gather_rows",
    "all_reduce_sum", "copy_to_group", "gather_columns",
    "all_reduce_gradients", "batch_shard", "batch_sum",
    "current_batch_shard",
]
