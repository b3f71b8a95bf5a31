from vcoder_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    current_mesh,
    make_mesh,
    single_device_mesh,
    use_mesh,
)
from vcoder_tpu_torch.parallel.sharding import (
    Placement,
    batch_sharding,
    device_shardings_like,
    host_shardings,
    leaf_sharder,
    offload_to_host,
    param_shardings,
    replicated,
    shard_batch,
    shard_params,
)

__all__ = [
    "AXES",
    "Mesh",
    "current_mesh",
    "make_mesh",
    "single_device_mesh",
    "use_mesh",
    "Placement",
    "batch_sharding",
    "device_shardings_like",
    "host_shardings",
    "leaf_sharder",
    "offload_to_host",
    "param_shardings",
    "replicated",
    "shard_batch",
    "shard_params",
]
