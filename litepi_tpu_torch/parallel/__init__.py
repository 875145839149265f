from litepi_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicated_sharding,
    shard_pipeline_batch,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_pipeline_batch",
]
