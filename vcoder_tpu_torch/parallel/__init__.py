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
    device_shardings_like,
    host_shardings,
    offload_to_host,
)

__all__ = [
    "AXES",
    "Mesh",
    "current_mesh",
    "make_mesh",
    "single_device_mesh",
    "use_mesh",
    "Placement",
    "device_shardings_like",
    "host_shardings",
    "offload_to_host",
]
