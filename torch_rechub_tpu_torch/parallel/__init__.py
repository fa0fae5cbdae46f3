"""The (data, model) mesh of ``torch.distributed`` ranks (``mesh.py``) and the process groups, collectives and
launcher under it (``distributed.py``); counterpart of ``torch_rechub_tpu/parallel``."""

from .mesh import (
    DATA_AXIS,
    DEFAULT_TABLE_HBM_BUDGET,
    MODEL_AXIS,
    SHARD_MIN_ROWS,
    DeviceMesh,
    MeshConfig,
    batch_sharding,
    create_mesh,
    plan_table_placement,
    replicated_sharding,
    scan_batch_sharding,
    shard_batch,
    shard_params,
    table_partition_spec,
)

__all__ = [
    "MeshConfig",
    "create_mesh",
    "batch_sharding",
    "replicated_sharding",
    "table_partition_spec",
    "shard_params",
    "shard_batch",
]
