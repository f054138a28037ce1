"""Data and tensor parallelism over ``torch.distributed`` ranks."""

from sudo_rm_rf_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    RowShards,
    batch_rows,
    launch_group,
    make_mesh,
    maybe_distributed_initialize,
    rank_device,
    shard_batch,
    shard_params,
    tp_param_shardings,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "RowShards",
    "batch_rows",
    "launch_group",
    "make_mesh",
    "maybe_distributed_initialize",
    "rank_device",
    "shard_batch",
    "shard_params",
    "tp_param_shardings",
]
