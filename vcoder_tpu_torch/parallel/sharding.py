"""Parameter and batch sharding over a mesh, and optimizer state in host
memory (port of ``vcoder_tpu/parallel/sharding.py``).

**Sharding rules** (``:25-160``). ``PARAM_RULES``, ``BATCH_AXES``,
``spec_for_path`` and ``_shrink_to_fit`` are copies of the JAX module's: a
leaf's path (``tree.py``'s convention) picks a spec, a tuple with one entry
per tensor dimension, each None, an axis name or a tuple of axis names (a
``PartitionSpec`` as a tuple); a dimension that an axis does not divide
drops it. :func:`param_shardings` turns each spec into DTensor placements
over the ``(data, fsdp, model)`` mesh: mesh dimension i gets ``Shard(j)``
when tensor dimension j names axis i, else ``Replicate()``; two axes on one
dimension shard it data-major, as JAX orders them. :func:`shard_params`
places a tree leaf by leaf, each rank keeping its slice of the same seeded
or loaded leaf, so no rank holds more than its shards and one whole leaf.

**Wrapped leaves** (``:77-142``). A ``QuantizedTensor`` (``q``, ``scale``),
``LoraWeight`` (``base``, itself possibly quantized, ``a``, ``b``) or
``MultiLoraWeight`` (``base``, ``a``, ``b``, ``idx``) is placed field by
field: each field takes the rule of the weight it wraps (the wrapper's path,
as JAX's ``_unwrap_path`` strips the fields by type, so a dict key named
``scale`` is never stripped) shrunk to the field's own shape. So a
``[.., 1, out]`` scale drops the axis its 1 cannot hold, a packed int4
``q`` keeps its axis only where the halved input axis divides, and the
wrapper comes back with DTensor fields. Packing is row-pair interleaved
(``ops/quant.py``), so a contiguous block of packed rows is a contiguous
block of input rows.

**Host offload** (``:163-223``). reference: scripts/zero3_offload.json --
DeepSpeed ZeRO-3 with ``offload_optimizer {device: cpu, pin_memory: true}``
for memory-tight full-LLM finetunes. The JAX package parks the optimizer-state leaves in
pinned host memory through a sharding's ``memory_kind``; here a leaf's
:class:`Placement` says where it lives, and ``train/step.py`` streams the
host leaves through the device a chunk at a time. At 7B ``full`` the Adam
moments in bf16 are ~27 GB, the largest training-only footprint.

Every shaped leaf goes to host memory, pinned when the mesh's device is CUDA
(a CPU mesh keeps it in ordinary memory: a CPU-only torch cannot pin). 0-d
leaves (``count``, ``mini_step``, ``gradient_step``) stay on the device, as
the JAX package's scalar note has them: moving them saves nothing.

Over a distributed mesh each rank holds the local shards of its state
(the moments of its parameter shards), so the same placements apply to
them per rank: each rank's shards go to its own pinned memory.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Tuple

import torch

from vcoder_tpu_torch.lora import LoraWeight, MultiLoraWeight
from vcoder_tpu_torch.ops.quant import QuantizedTensor
from vcoder_tpu_torch.parallel.mesh import AXES, Mesh, multi_device_error

# ---- sharding rules (copies of the JAX module's ``:25-160``) ----

# (path regex, spec). First match wins. Paths are '/'-joined key
# sequences, e.g. "lm/layers/q_proj" or "mm_projector/w/0".
PARAM_RULES = [
    # --- Llama decoder ---
    (r"^lm/embed_tokens$", ("fsdp", "model")),
    (r"^lm/layers/(input|post_attention)_layernorm$", ()),
    (r"^lm/layers/[qkv]_proj$", (None, "fsdp", "model")),
    (r"^lm/layers/o_proj$", (None, "model", "fsdp")),
    (r"^lm/layers/(gate|up)_proj$", (None, "fsdp", "model")),
    (r"^lm/layers/down_proj$", (None, "model", "fsdp")),
    (r"^lm/norm$", ()),
    (r"^lm/lm_head$", ("fsdp", "model")),
    (r"^vcoder_lm_emb$", ("fsdp", "model")),
    # --- CLIP tower ---
    (r"^vision_tower/class_embedding$", ()),
    (r"^vision_tower/patch_embedding$", ("fsdp", "model")),
    (r"^vision_tower/position_embedding$", (None, "model")),
    (r"^vision_tower/pre_layernorm/.*$", ()),
    (r"^vision_tower/layers/ln[12]_(scale|bias)$", ()),
    (r"^vision_tower/layers/[qkv]_proj$", (None, "fsdp", "model")),
    (r"^vision_tower/layers/[qkv]_bias$", (None, "model")),
    (r"^vision_tower/layers/out_proj$", (None, "model", "fsdp")),
    (r"^vision_tower/layers/out_bias$", ()),
    (r"^vision_tower/layers/fc1$", (None, "fsdp", "model")),
    (r"^vision_tower/layers/fc1_bias$", (None, "model")),
    (r"^vision_tower/layers/fc2$", (None, "model", "fsdp")),
    (r"^vision_tower/layers/fc2_bias$", ()),
    # --- projectors (mm / mm2 / seg / depth): small MLPs, fsdp-shard the
    # matrices, replicate biases ---
    (r"^(mm|mm2|seg|depth)_projector/w/\d+$", ("fsdp", None)),
    (r"^(mm|mm2|seg|depth)_projector/b/\d+$", ()),
]

# Batch-bearing activations shard their leading axis over (data, fsdp):
# fsdp ranks process distinct samples and gather parameter shards at use.
BATCH_AXES = ("data", "fsdp")

Spec = Tuple


def spec_for_path(path_str: str) -> Spec:
    """The first rule matching ``path_str`` (quantized ``/q``, ``/scale``
    and LoRA ``/base``, ``/a``, ``/b`` suffixes stripped), else replicated."""
    path_str = re.sub(r"(/(q|scale|base|a|b))+$", "", path_str)
    for pattern, spec in PARAM_RULES:
        if re.match(pattern, path_str):
            return spec
    return ()


def _shrink_to_fit(spec: Spec, shape, mesh: Mesh) -> Spec:
    """Drop mesh axes from a spec when the dimension isn't divisible by the
    axis size (tiny test configs) or the spec has more dims than the leaf."""
    if len(spec) > len(shape):
        return ()
    out: List = []
    for dim, names in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if names is None:
            out.append(None)
            continue
        size = 1
        for nm in names if isinstance(names, tuple) else (names,):
            size *= mesh.shape[nm]
        out.append(names if dim % size == 0 else None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements_of(spec: Spec, mesh: Mesh) -> tuple:
    """DTensor placements over the mesh's three dimensions for ``spec``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(AXES)
    for j, names in enumerate(spec):
        for nm in (names if isinstance(names, tuple) else (names,)) if names else ():
            out[mesh.axis_names.index(nm)] = Shard(j)
    return tuple(out)


# The tensor fields of each weight wrapper (JAX's ``_WRAPPER_FIELDS``).
_WRAPPER_FIELDS = {
    QuantizedTensor: ("q", "scale"),
    LoraWeight: ("base", "a", "b"),
    MultiLoraWeight: ("base", "a", "b", "idx"),
}


def _is_wrapper(leaf) -> bool:
    return type(leaf) in _WRAPPER_FIELDS


def _map_fields(leaf, fn):
    """The wrapper ``leaf`` with ``fn(name, field)`` in place of each tensor
    field (nested wrappers are fields too; ``bits`` and ``scale`` floats
    kept)."""
    return dataclasses.replace(leaf, **{n: fn(n, getattr(leaf, n))
                                        for n in _WRAPPER_FIELDS[type(leaf)]})


def _leaves(params) -> List[Tuple[str, Any]]:
    """(path, leaf) in ``tree.py``'s path convention, with quantized and
    LoRA wrappers kept whole."""
    out = []

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
        else:
            out.append((prefix, tree))

    walk(params, "")
    return out


def _fields(path: str, leaf, rule_path: str = None):
    """(field path, rule path, tensor) for every tensor of one leaf: a
    wrapper's fields under ``path/<field>`` with the wrapper's own path as
    the rule path."""
    rule_path = rule_path or path
    if not _is_wrapper(leaf):
        yield path, rule_path, leaf
        return
    for name in _WRAPPER_FIELDS[type(leaf)]:
        yield from _fields(f"{path}/{name}", getattr(leaf, name), rule_path)


def _field_spec(rule_path: str, shape, mesh: Mesh) -> Spec:
    """The rule of ``rule_path`` shrunk to ``shape``."""
    return _shrink_to_fit(spec_for_path(rule_path), tuple(shape), mesh)


def param_specs(params, mesh: Mesh) -> Dict[str, Spec]:
    """{tensor path: spec after ``_shrink_to_fit``} (what JAX's
    ``param_shardings`` puts in each ``NamedSharding``), wrapper fields
    included."""
    return {fp: _field_spec(rp, t.shape, mesh)
            for path, leaf in _leaves(params) for fp, rp, t in _fields(path, leaf)}


def param_shardings(params, mesh: Mesh) -> Dict[str, tuple]:
    """{tensor path: DTensor placements} mirroring ``params``."""
    return {p: placements_of(s, mesh) for p, s in param_specs(params, mesh).items()}


def local_block(t: torch.Tensor, device_mesh, placements) -> torch.Tensor:
    """This rank's block of ``t`` (the same whole tensor on every rank)
    under ``placements`` over ``device_mesh``, cut mesh dimension by mesh
    dimension as DTensor splits (two axes on one dimension data-major): a
    view, no communication."""
    for i, p in enumerate(placements):
        n = device_mesh.size(i)
        if p.is_shard() and n > 1:
            t = t.chunk(n, dim=p.dim)[device_mesh.get_local_rank(i)]
    return t


def whole_layer(w, l: int) -> torch.Tensor:
    """Layer ``l`` of a stacked leaf, whole: a DTensor's layer gathered from
    every rank's slice of it (the layer axis is never split), so a sharded
    leaf is never gathered whole at once."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(w, DTensor):
        return w[l]
    shape = w.shape[1:]
    layer = DTensor.from_local(w.to_local()[l], w.device_mesh,
                               [Shard(p.dim - 1) if p.is_shard() else p for p in w.placements],
                               run_check=False, shape=shape,
                               stride=torch.empty(shape, device="meta").stride())
    return layer.full_tensor()


def _distribute(t: torch.Tensor, mesh: Mesh, placements) -> torch.Tensor:
    """This rank's slice of ``t`` (the same on every rank) as a DTensor
    (:func:`local_block`): no communication, one copy of the slice (none
    when nothing splits ``t``), so the caller can free ``t``."""
    from torch.distributed.tensor import DTensor

    t = t.detach()
    local = local_block(t, mesh.device_mesh, placements)
    if local.numel() < t.numel():
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh.device_mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def shard_leaf(path: str, t, mesh: Mesh, rule_path: str = None):
    """This rank's slice of one leaf by the rules, as a DTensor (a DTensor
    stays as it is); a wrapper comes back with each field sliced by its
    weight's rule. Anything else raises ``TypeError``."""
    from torch.distributed.tensor import DTensor

    rule_path = rule_path or path
    if _is_wrapper(t):
        return _map_fields(t, lambda name, f: shard_leaf(f"{path}/{name}", f, mesh, rule_path))
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{path}: a {type(t).__name__} leaf cannot be placed on a mesh")
    if isinstance(t, DTensor):
        return t
    spec = _field_spec(rule_path, t.shape, mesh)
    return _distribute(t.to(mesh.device), mesh, placements_of(spec, mesh))


def leaf_sharder(mesh: Mesh):
    """``place(path, leaf)`` for the parameter builders and checkpoint
    loaders (their ``place=``): each leaf is sharded as soon as it is made,
    before the next one, so a rank never holds more than its shards and one
    whole leaf. None when the mesh is not distributed."""
    if mesh is None or not mesh.distributed:
        return None
    return lambda path, t: shard_leaf(path, t, mesh)


def shard_params(params, mesh: Mesh):
    """Place ``params`` on the mesh by the rules, leaf by leaf, IN the
    caller's dictionaries (each whole leaf is dropped as soon as its slice
    is kept; a leaf that is a DTensor already stays, and so does a
    wrapper's DTensor field); returns ``params``. Every rank must pass the
    same tree."""
    if not mesh.distributed:
        if mesh.size > 1:
            raise multi_device_error(mesh.size)
        return params
    for path, leaf in _leaves(params):  # refused before any leaf is replaced
        for fp, _, t in _fields(path, leaf):
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"{fp}: a {type(t).__name__} leaf cannot be placed on a mesh")

    def walk(tree, prefix):
        keys = tree.keys() if isinstance(tree, dict) else range(len(tree))
        for k in keys:
            path = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(tree[k], (dict, list)):
                walk(tree[k], path)
            else:
                tree[k] = shard_leaf(path, tree[k], mesh)

    walk(params, "")
    return params


def batch_sharding(mesh: Mesh, ndim: int = 2) -> tuple:
    """Leading-axis batch placements for inputs of rank ``ndim`` (scalars
    replicate)."""
    return placements_of((BATCH_AXES,) if ndim else (), mesh)


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Shard every tensor of a batch over its leading axis: DTensors whose
    local part is this rank's rows. Every rank passes the same global batch."""
    n = mesh.row_shards
    for k, x in batch.items():
        if x.ndim and x.shape[0] % n:
            raise ValueError(f"batch leaf {k} of {x.shape[0]} rows over {n} row shards")
    return {k: _distribute(x, mesh, batch_sharding(mesh, x.ndim)) for k, x in batch.items()}


def replicated(mesh: Mesh) -> tuple:
    return placements_of((), mesh)


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
    every shaped leaf, the device for 0-d leaves (this rank's device over a
    distributed mesh; its local shards are what it places)."""
    dev = mesh.device
    host = "pinned_host" if dev.type == "cuda" else "unpinned_host"
    return {k: Placement(dev, host if t.ndim else "device") for k, t in tree.items()}


def device_shardings_like(host_sh: Dict[str, Placement]) -> Dict[str, Placement]:
    """The device twins of a host-placement dict."""
    return {k: Placement(s.device, "device") for k, s in host_sh.items()}


def offload_to_host(tree: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Move a flat state dict to :func:`host_shardings`' placements."""
    sh = host_shardings(tree, mesh)
    return {k: sh[k].place(_local(t)) for k, t in tree.items()}


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t
