"""Whole-model weight-only quantization (port of ``vcoder_tpu/quant.py``).

Maps the reference's ``load_8bit`` / ``load_4bit`` flags (bitsandbytes int8
and NF4 in the reference) to int8 / int4 weight-only quantization of the
large matmul weights (``ops/quant.py``). Embedding tables, norms, biases and
the small projector MLPs keep their dtype. A leaf's path is its dict keys and
list indices joined by ``/`` (the convention of the JAX package's
``parallel/sharding.py::_path_str``, of which this is a copy for the port's
plain dictionaries).

Over a distributed mesh a leaf is quantized whole, then placed: a scale is
the absmax over the input axis, and a leaf split by rows over ``model``
(``o_proj``, ``down_proj``) would get other scales from each shard's
absmax. :func:`quantize_params` gathers a sharded leaf, quantizes it and
hands it to ``place`` (``parallel.leaf_sharder``); :func:`leaf_quantizer`
does the same for the loaders' and builders' ``place=`` hooks, so a rank
holds its shards and one whole leaf at a time.
"""

from __future__ import annotations

import re
from typing import Any

import torch

from vcoder_tpu_torch.ops.quant import QuantizedTensor, quantize
from vcoder_tpu_torch.parallel.sharding import whole_layer

# Large matmul weights worth quantizing (the 7B/13B decoder dominates).
QUANTIZE_PATHS = [
    r"^lm/layers/[qkv]_proj$",
    r"^lm/layers/o_proj$",
    r"^lm/layers/(gate|up|down)_proj$",
    r"^lm/lm_head$",
    r"^vision_tower/layers/[qkv]_proj$",
    r"^vision_tower/layers/out_proj$",
    r"^vision_tower/layers/fc[12]$",
]
_PATTERNS = [re.compile(p) for p in QUANTIZE_PATHS]


def _quantized(path: str) -> bool:
    return any(p.match(path) for p in _PATTERNS)


def _quantize_leaf(w: torch.Tensor, bits: int) -> QuantizedTensor:
    """:func:`quantize` on the leaf's device; a stacked ``[L, in, out]`` leaf
    goes one layer at a time into preallocated outputs, so the f32
    transients stay one layer's size (the same values: the scale reduces
    over the input axis of each layer). A sharded leaf (a DTensor; every
    rank of its mesh calls this) is gathered a layer at a time and comes
    back whole."""
    if w.ndim != 3:
        return quantize(w.full_tensor() if hasattr(w, "full_tensor") else w, bits)
    L, K, N = w.shape
    q = torch.empty((L, K // 2 if bits == 4 else K, N), dtype=torch.int8, device=w.device)
    scale = torch.empty((L, 1, N), dtype=torch.float32, device=w.device)
    for l in range(L):
        ql = quantize(whole_layer(w, l), bits)
        q[l], scale[l] = ql.q, ql.scale
    return QuantizedTensor(q=q, scale=scale, bits=bits)


def leaf_quantizer(bits: int, place=None):
    """``place(path, leaf)`` that quantizes a leaf of ``QUANTIZE_PATHS``
    (whole, on its device) and hands every leaf on to ``place`` when given:
    the ``place=`` hook of the loaders and builders for quantized weights
    over a mesh."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def put(path, t):
        if isinstance(t, torch.Tensor) and _quantized(path):
            t = _quantize_leaf(t, bits)
        return t if place is None else place(path, t)

    return put


def quantize_params(params: Any, bits: int = 8, destroy: bool = True, place=None) -> Any:
    """Quantize the heavyweight matmul leaves of a parameter tree, leaf by
    leaf on each leaf's device. With ``destroy=True`` (default) the input's
    containers are updated in place, each full-precision leaf replaced as
    soon as its quantized form exists, so its memory frees before the next
    leaf is quantized; ``destroy=False`` leaves the input untouched.

    A sharded leaf (a DTensor) is quantized whole, gathered a layer at a
    time (every rank of its mesh calls this), and handed to ``place``
    (``parallel.leaf_sharder``), which a sharded tree needs; other leaves go
    to ``place`` only when they are quantized."""
    from torch.distributed.tensor import DTensor

    put = leaf_quantizer(bits, place)

    def walk(node, path):
        if isinstance(node, dict):
            items = node if destroy else dict(node)
            for k in list(items.keys()):
                items[k] = walk(items[k], path + (k,))
            return items
        if isinstance(node, list):
            items = node if destroy else list(node)
            for i in range(len(items)):
                items[i] = walk(items[i], path + (str(i),))
            return items
        name = "/".join(path)
        if not (isinstance(node, torch.Tensor) and _quantized(name)):
            return node
        if isinstance(node, DTensor) and place is None:
            raise ValueError(f"{name} is sharded: quantize_params needs place= "
                             "(parallel.leaf_sharder(mesh)) to place its quantized form")
        return put(name, node)

    return walk(params, ())


def init_quantized_params(cfg, bits: int = 8, *, seed: int = 0, dtype=torch.bfloat16,
                          device="cuda", place=None) -> dict:
    """Random weights sampled directly in quantized form, leaf by leaf, so a
    model that would not fit in ``dtype`` never materializes there. The
    quantized leaves get int8 values in ``[-qmax, qmax]`` (int4: two such
    nibbles packed per byte) and a constant scale ``0.02 / qmax``; norm
    weights are ones, biases zeros, the rest ``N(0, 0.02)``, as
    ``vcoder_tpu/quant.py::init_quantized_params`` does. The draws come from
    a ``torch.Generator`` seeded with ``seed``: the structure and the
    distributions match the JAX package's, the values do not.
    ``place(path, leaf)`` takes each leaf as it is made (over a mesh,
    ``parallel.leaf_sharder``: every rank draws the same leaf and keeps its
    shards)."""
    from vcoder_tpu_torch.device import resolve_device
    from vcoder_tpu_torch.models.vcoder import build_vcoder_params

    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    dev = resolve_device(device)
    # The tree's structure and shapes, with no storage.
    shapes = build_vcoder_params(cfg, torch.Generator(), dtype=dtype, device="meta")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qmax = 127 if bits == 8 else 7

    def sample(shape):
        return torch.randint(-qmax, qmax + 1, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def leaf(path: str, sds: torch.Tensor):
        shape = tuple(sds.shape)
        if _quantized(path):
            if bits == 8:
                q = sample(shape)
            else:  # the packed bytes directly: two nibbles a byte
                half = shape[:-2] + (shape[-2] // 2, shape[-1])
                q = (sample(half) & 0x0F) | (sample(half) << 4)
            scale = torch.full(shape[:-2] + (1, shape[-1]), 0.02 / qmax,
                               dtype=torch.float32, device=dev)
            return QuantizedTensor(q=q, scale=scale, bits=bits)
        if re.search(r"(layernorm|/norm$|ln\d_(scale|bias)|/scale$)", path):
            fill = torch.zeros if "bias" in path else torch.ones
            return fill(shape, dtype=sds.dtype, device=dev)
        if "bias" in path or re.search(r"/b/\d+$", path):
            return torch.zeros(shape, dtype=sds.dtype, device=dev)
        return torch.randn(shape, generator=gen, dtype=sds.dtype, device=dev).mul_(0.02)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        name = "/".join(path)
        return leaf(name, node) if place is None else place(name, leaf(name, node))

    return walk(shapes, ())
