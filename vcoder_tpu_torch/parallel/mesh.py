"""Device meshes and the active-mesh context (port of
``vcoder_tpu/parallel/mesh.py:37-117``).

A mesh names three logical axes over its devices, as in the JAX package:

* ``data``  -- pure data parallelism (batch sharding),
* ``fsdp``  -- parameter/optimizer sharding gathered at use (ZeRO-3 analog),
* ``model`` -- tensor parallelism over attention heads / MLP width.

:class:`Mesh` is a plain ``[data, fsdp, model]`` array of ``torch.device``
with the surface the package reads (``shape``, ``size``, ``devices``,
``axis_names``). Without a process group it stays that plain array (a
one-device mesh needs none). With one (``parallel/launch.py``: torchrun or
``spawn``), :func:`make_mesh` lays the group's ranks out by the same axis
rule and wraps ``init_device_mesh`` as :attr:`Mesh.device_mesh`; each
process is one rank of the mesh and :attr:`Mesh.device` is its own device.
The port's SPMD code (``parallel/spmd.py``) engages whenever the mesh is
distributed, even over one rank (JAX's gate is ``mesh.size > 1``; the
results are the same either way). A plain mesh of several devices has no
processes to run them: ``Mesh.device`` and every consumer refuse it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vcoder_tpu_torch.device import resolve_device

AXES = ("data", "fsdp", "model")

# Thread-local: concurrent engine/train threads must not see (or pop) each
# other's active mesh.
_TLS = threading.local()


def _mesh_stack() -> list:
    stack = getattr(_TLS, "mesh_stack", None)
    if stack is None:
        stack = _TLS.mesh_stack = []
    return stack


def multi_device_error(n: int) -> NotImplementedError:
    return NotImplementedError(
        f"a multi-device mesh of {n} devices without a process group: the port runs one "
        "process per device (launch with python -m torch.distributed.run, or "
        "parallel/launch.spawn, then build the mesh with make_mesh)")


class Mesh:
    """``devices``: an array of ``torch.device`` shaped like ``axis_names``
    (rank order, row-major); ``device_mesh``: the ``DeviceMesh`` over the
    process group's ranks, or None for a plain mesh."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = AXES,
                 device_mesh=None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of shape {devices.shape} for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.device_mesh = device_mesh
        self._rows = None

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    def local_rank(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on a plain mesh)."""
        return self.device_mesh.get_local_rank(axis) if self.distributed else 0

    @property
    def row_shards(self) -> int:
        return self.shape["data"] * self.shape["fsdp"]

    @property
    def row_index(self) -> int:
        """This rank's row shard, data-major over (data, fsdp)."""
        return self.local_rank("data") * self.shape["fsdp"] + self.local_rank("fsdp")

    @property
    def rows_mesh(self):
        """The 1-D ``DeviceMesh`` of the ranks that share this rank's model
        coordinate: ``("data", "fsdp")`` flattened, so a row collective is
        one call, not one per axis."""
        if self._rows is None:
            self._rows = self.device_mesh["data", "fsdp"]._flatten("rows")
        return self._rows

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """This rank's device (the only one of a plain one-device mesh)."""
        if self.distributed:
            import torch.distributed as dist

            return self.devices.flat[dist.get_rank()]
        if self.size != 1:
            raise multi_device_error(self.size)
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(
    devices: Optional[Sequence] = None,
    *,
    data: Optional[int] = None,
    fsdp: Optional[int] = None,
    model: Optional[int] = None,
) -> Mesh:
    """Build a ``(data, fsdp, model)`` mesh over ``devices`` (every CUDA
    device when None; raises without CUDA).

    Unspecified axes default to 1 except ``fsdp``, which absorbs the
    remaining device count (ZeRO-3-style sharding is the default scaling
    mode, matching the reference's DeepSpeed stage-3 configs).

    Inside a process group (``parallel/launch.py``) the mesh is over the
    group's ranks instead: ``devices`` may be None (each rank's CUDA device,
    ``cuda:LOCAL_RANK``; the CPU on a gloo group) or one device per rank,
    the axis rule and its errors are the same, and the result carries the
    ``DeviceMesh``.
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return _group_mesh(devices, data=data, fsdp=fsdp, model=model)
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    sizes = _axis_sizes(len(devices), data, fsdp, model)
    devices = devices[: int(np.prod(list(sizes.values())))]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(sizes[k] for k in AXES)), AXES)


def _group_mesh(devices, *, data, fsdp, model) -> Mesh:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if devices is None:
        if dist.get_backend() == "nccl":
            n_local = torch.cuda.device_count()
            devices = [torch.device("cuda", r % n_local) for r in range(world)]
        else:
            devices = [torch.device("cpu")] * world
    devices = [torch.device(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for a process group of {world} ranks")
    sizes = _axis_sizes(world, data, fsdp, model)
    if int(np.prod(list(sizes.values()))) != world:
        raise ValueError(f"Axis sizes {sizes} do not cover the {world} ranks of the group")
    shape = tuple(sizes[k] for k in AXES)
    dm = init_device_mesh(devices[0].type, shape, mesh_dim_names=AXES)
    arr = np.empty(world, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), AXES, device_mesh=dm)


def _axis_sizes(n: int, data, fsdp, model) -> Dict[str, int]:
    """JAX's axis rule (``mesh.py:44-89``) over ``n`` devices."""
    sizes = {"data": data, "fsdp": fsdp, "model": model}
    fixed = {k: v for k, v in sizes.items() if v is not None}
    prod_fixed = int(np.prod(list(fixed.values()))) if fixed else 1
    if len(fixed) == 3:
        # Fully specified: take exactly that many devices.
        if prod_fixed > n:
            raise ValueError(f"requested {fixed} needs {prod_fixed} devices, have {n}")
        return sizes
    if n % prod_fixed != 0:
        raise ValueError(f"{n} devices not divisible by {fixed}")
    remaining = n // prod_fixed
    for k in AXES:
        if sizes[k] is None:
            sizes[k] = remaining if k == "fsdp" else 1
            remaining = 1 if k == "fsdp" else remaining
    if remaining != 1:
        # No free fsdp axis took the remainder: sizes must already multiply
        # out to n.
        raise ValueError(f"Axis sizes {sizes} do not cover {n} devices")
    return sizes


def single_device_mesh(device="cuda") -> Mesh:
    """Degenerate 1x1x1 mesh over ``device`` (one-card serving and training);
    a plain mesh even inside a process group."""
    dev = np.empty(1, dtype=object)
    dev[:] = [resolve_device(device)]
    return Mesh(dev.reshape(1, 1, 1), AXES)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` this thread's active mesh (:func:`current_mesh`)."""
    stack = _mesh_stack()
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def current_mesh() -> Optional[Mesh]:
    stack = _mesh_stack()
    return stack[-1] if stack else None


def distributed_mesh() -> Optional[Mesh]:
    """The active mesh when it is distributed (the SPMD path), else None."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.distributed else None


def rank_zero() -> bool:
    """True outside a process group and on its rank 0 (the rank that writes
    files)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the process group (nothing outside one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()
