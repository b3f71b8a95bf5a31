"""Device meshes and the active-mesh context (port of
``vcoder_tpu/parallel/mesh.py:37-117``).

A mesh names three logical axes over its devices, as in the JAX package:

* ``data``  -- pure data parallelism (batch sharding),
* ``fsdp``  -- parameter/optimizer sharding gathered at use (ZeRO-3 analog),
* ``model`` -- tensor parallelism over attention heads / MLP width.

:class:`Mesh` is a plain ``[data, fsdp, model]`` array of ``torch.device``
with the surface the package reads (``shape``, ``size``, ``devices``,
``axis_names``). It is not a ``torch.distributed.DeviceMesh``: building one
needs an initialised process group, and a one-device mesh needs none. The
port runs on one device; a mesh above one device is refused where it is
used (``Trainer``, the stage drivers, the engines).
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


class Mesh:
    """``devices``: an array of ``torch.device`` shaped like ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = AXES):
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of shape {devices.shape} for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The device of a one-device mesh."""
        if self.size != 1:
            raise NotImplementedError(
                f"a mesh of {self.size} devices belongs to the port's multi-device slice"
            )
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
    """
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    sizes = {"data": data, "fsdp": fsdp, "model": model}
    fixed = {k: v for k, v in sizes.items() if v is not None}
    prod_fixed = int(np.prod(list(fixed.values()))) if fixed else 1
    if len(fixed) == 3:
        # Fully specified: take exactly that many devices.
        if prod_fixed > len(devices):
            raise ValueError(
                f"requested {fixed} needs {prod_fixed} devices, have {len(devices)}"
            )
        devices = devices[:prod_fixed]
    n = len(devices)
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
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(sizes[k] for k in AXES)), AXES)


def single_device_mesh(device="cuda") -> Mesh:
    """Degenerate 1x1x1 mesh over ``device`` (one-card serving and training)."""
    return make_mesh([resolve_device(device)], data=1, fsdp=1, model=1)


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
