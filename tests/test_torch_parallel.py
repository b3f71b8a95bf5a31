"""The port's mesh shell (``vcoder_tpu_torch/parallel/mesh.py``) against the
JAX package's ``vcoder_tpu/parallel/mesh.py`` on the CPU.

``make_mesh`` over n of the virtual CPU devices (tests/conftest.py makes
8) and the port's over n CPU ``torch.device``s must give the same
``{data, fsdp, model}`` shape, or both raise ``ValueError``, for every
axis combination below (those of the JAX package's tests, and the
error cases of its rule). The mesh stack nests and is thread-local.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from vcoder_tpu.parallel import mesh as jmesh
from vcoder_tpu_torch.parallel import mesh as tmesh

COMBOS = [
    {},
    {"data": 2},
    {"fsdp": 2},
    {"model": 2},
    {"data": 2, "model": 2},
    {"data": 2, "fsdp": 2, "model": 2},
    {"data": 1, "fsdp": 1, "model": 1},
    {"data": 2, "fsdp": 1, "model": 1},
    {"data": 3},
    {"data": 2, "fsdp": 2, "model": 4},
    {"data": 1, "fsdp": 2},
    {"fsdp": 4, "model": 1},
]


def _jax(n, kw):
    try:
        return dict(jmesh.make_mesh(jax.devices()[:n], **kw).shape)
    except ValueError:
        return ValueError


def _torch(n, kw):
    try:
        m = tmesh.make_mesh([torch.device("cpu")] * n, **kw)
    except ValueError:
        return ValueError
    assert m.devices.shape == tuple(m.shape[a] for a in tmesh.AXES)
    assert m.size == m.devices.size and m.axis_names == tmesh.AXES
    return m.shape


@pytest.mark.parametrize("kw", COMBOS, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items())
                         or "default")
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_matches_jax(n, kw):
    assert len(jax.devices()) >= 8
    assert _torch(n, kw) == _jax(n, kw)


def test_axes_and_one_device_meshes():
    assert tmesh.AXES == jmesh.AXES
    m = tmesh.single_device_mesh("cpu")
    assert m.shape == dict(jmesh.single_device_mesh().shape) == {"data": 1, "fsdp": 1, "model": 1}
    assert m.device == torch.device("cpu")
    big = tmesh.make_mesh(["cpu"] * 4, data=2)
    assert big.shape == {"data": 2, "fsdp": 2, "model": 1}
    # A plain mesh of several devices has no processes to run them...
    with pytest.raises(NotImplementedError, match="multi-device.*torch.distributed.run.*spawn"):
        big.device
    # ... a process group per device does: each rank's mesh, its own device.
    from tests.test_torch_sharding import mesh_rank
    from vcoder_tpu_torch.parallel import launch

    got = launch.spawn(mesh_rank, 4, {"data": 2}, timeout_s=120)
    assert got == [({"data": 2, "fsdp": 2, "model": 1}, "cpu", True)] * 4


def test_make_mesh_needs_cuda_unless_given_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.single_device_mesh()
    assert tmesh.make_mesh(["cpu"]).size == 1


def test_mesh_stack_nests_and_is_thread_local():
    a, b = tmesh.single_device_mesh("cpu"), tmesh.make_mesh(["cpu"] * 2)
    assert tmesh.current_mesh() is None
    seen = []
    with tmesh.use_mesh(a) as got:
        assert got is a and tmesh.current_mesh() is a
        with tmesh.use_mesh(b):
            assert tmesh.current_mesh() is b
            t = threading.Thread(target=lambda: seen.append(tmesh.current_mesh()))
            t.start()
            t.join()
        assert tmesh.current_mesh() is a
        with pytest.raises(KeyError):
            with tmesh.use_mesh(b):
                raise KeyError("popped on the way out")
        assert tmesh.current_mesh() is a
    assert tmesh.current_mesh() is None
    assert seen == [None]


def test_mesh_devices_array_keeps_their_order():
    devs = [torch.device("cpu")] * 8
    m = tmesh.make_mesh(devs, data=2, model=2)
    assert m.devices.shape == (2, 2, 2) and all(d == torch.device("cpu")
                                                for d in np.ravel(m.devices))
