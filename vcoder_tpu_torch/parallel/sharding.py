"""Optimizer state in host memory: the one-device half of
``vcoder_tpu/parallel/sharding.py`` (its host offload, ``:163-223``).

reference: scripts/zero3_offload.json -- DeepSpeed ZeRO-3 with
``offload_optimizer {device: cpu, pin_memory: true}`` for memory-tight
full-LLM finetunes. The JAX package parks the optimizer-state leaves in
pinned host memory through a sharding's ``memory_kind``; here a leaf's
:class:`Placement` says where it lives, and ``train/step.py`` streams the
host leaves through the device a chunk at a time. At 7B ``full`` the Adam
moments in bf16 are ~27 GB, the largest training-only footprint.

Every shaped leaf goes to host memory, pinned when the mesh's device is CUDA
(a CPU mesh keeps it in ordinary memory: a CPU-only torch cannot pin). 0-d
leaves (``count``, ``mini_step``, ``gradient_step``) stay on the device, as
the JAX package's scalar note has them: moving them saves nothing.

The path -> ``PartitionSpec`` rules of the JAX module (``spec_for_path``,
``param_shardings``, ``shard_params``, ``shard_batch``, ``batch_sharding``,
``replicated``) belong to the multi-device slice and are not here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from vcoder_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one state leaf lives. ``device``: the mesh's device the leaf
    serves; ``memory_kind``: ``"device"`` (on it), ``"pinned_host"`` (page-locked
    CPU memory, for a CUDA device) or ``"unpinned_host"`` (CPU memory, for a
    CPU device)."""

    device: torch.device
    memory_kind: str

    @property
    def on_host(self) -> bool:
        return self.memory_kind != "device"

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` where this placement says (``t`` itself when it is
        there already)."""
        if not self.on_host:
            return t.to(self.device)
        if self.memory_kind == "pinned_host":
            if t.device.type == "cpu" and t.is_pinned():
                return t
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return out.copy_(t)
        return t.to("cpu")

    def zeros(self, t: torch.Tensor) -> torch.Tensor:
        """Zeros shaped like ``t`` (any device, ``meta`` included) where this
        placement says."""
        if not self.on_host:
            return torch.zeros(t.shape, dtype=t.dtype, device=self.device)
        return torch.zeros(t.shape, dtype=t.dtype, pin_memory=self.memory_kind == "pinned_host")


def host_shardings(tree: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, Placement]:
    """A :class:`Placement` per leaf of a flat state dict: host memory for
    every shaped leaf, the device for 0-d leaves."""
    dev = mesh.device
    host = "pinned_host" if dev.type == "cuda" else "unpinned_host"
    return {k: Placement(dev, host if t.ndim else "device") for k, t in tree.items()}


def device_shardings_like(host_sh: Dict[str, Placement]) -> Dict[str, Placement]:
    """The device twins of a host-placement dict."""
    return {k: Placement(s.device, "device") for k, s in host_sh.items()}


def offload_to_host(tree: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Move a flat state dict to :func:`host_shardings`' placements."""
    sh = host_shardings(tree, mesh)
    return {k: sh[k].place(t) for k, t in tree.items()}
