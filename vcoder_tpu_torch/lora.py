"""LoRA: low-rank adapters as weight wrappers (port of ``vcoder_tpu/lora.py``).

A :class:`LoraWeight` wraps any matmul leaf of a parameter tree; ``qmatmul``
(``ops/quant.py``) computes ``x @ W + scale * (x @ A) @ B`` without building
the merged matrix, so the frozen base may stay int8/int4 underneath.
:func:`merge_lora` folds adapters back into plain weights (PEFT's
``merge_and_unload``).

Multi-LoRA serving: :func:`stack_adapters` turns every targeted weight into a
:class:`MultiLoraWeight` holding ``[zero, adapter_1, ..., adapter_n]`` and a
per-row index ``idx [L, B]``; each decode row picks its adapter by index.
:func:`single_adapter_view` slices one adapter out for a B=1 prefill.

The wrappers are plain dataclasses, not pytrees: a tree is walked with the
port's path convention (dict keys and list indices joined by ``/``, as
``tree.py``), and indexing a wrapper slices the leading (layer) axis of each
of its tensors, so ``{k: v[l] for k, v in layers.items()}`` gives one layer's
weights. :func:`set_row_adapter` writes the index IN PLACE (the JAX package
returns a new tree); every view of it sees the write.

Over a distributed mesh (``parallel/sharding.py``) a wrapper's fields are
DTensors. :func:`add_lora` draws each ``a`` whole from the same generator
as on one device and hands each new wrapper to ``place`` (``leaf_sharder``)
before the next; :func:`merge_lora` gathers one layer's fields at a time,
folds them and keeps this rank's block of the merged weight;
:func:`extract_adapters` gathers one adapter at a time.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import re
from typing import Any, Dict, Sequence, Tuple

import torch

from vcoder_tpu_torch.ops.quant import QuantizedTensor, dequantize, qmatmul

# The reference LoRA-targets every linear of the LM (find_all_linear_names
# skips the projectors, lm_head and the vision tower).
DEFAULT_TARGETS = [
    r"^lm/layers/[qkv]_proj$",
    r"^lm/layers/o_proj$",
    r"^lm/layers/(gate|up|down)_proj$",
]


def _device(w) -> torch.device:
    return (w.q if isinstance(w, QuantizedTensor) else w).device


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _whole(t):
    """A DTensor gathered whole (every rank of its mesh must call), a
    quantized weight with its fields gathered; anything else as is."""
    if isinstance(t, QuantizedTensor):
        return QuantizedTensor(_whole(t.q), _whole(t.scale), t.bits)
    return t.full_tensor() if _is_dtensor(t) else t


@dataclasses.dataclass
class LoraWeight:
    """base: ``[..., in, out]`` (plain or quantized); a: ``[..., in, r]``;
    b: ``[..., r, out]``; scale = alpha / r."""

    base: Any
    a: torch.Tensor
    b: torch.Tensor
    scale: float

    @property
    def shape(self):
        return self.base.shape

    @property
    def ndim(self) -> int:
        return self.base.ndim

    def __getitem__(self, idx) -> "LoraWeight":
        return LoraWeight(self.base[idx], self.a[idx], self.b[idx], self.scale)


@dataclasses.dataclass
class MultiLoraWeight:
    """base: ``[L, in, out]`` (plain or quantized); a: ``[L, n, in, R]``;
    b: ``[L, n, R, out]`` (each adapter's alpha/r folded into b, ranks
    zero-padded to R, index 0 the zero "no adapter"); idx: ``[L, B]`` int32,
    each row's adapter, repeated per layer so a layer slice carries it."""

    base: Any
    a: torch.Tensor
    b: torch.Tensor
    idx: torch.Tensor

    @property
    def shape(self):
        return self.base.shape

    @property
    def ndim(self) -> int:
        return self.base.ndim

    def __getitem__(self, i) -> "MultiLoraWeight":
        return MultiLoraWeight(self.base[i], self.a[i], self.b[i], self.idx[i])


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple))


def _map_with_path(tree, fn, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists; tensors, quantized
    tensors and LoRA wrappers are leaves."""
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(v, fn, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def adapter_scale(acfg: dict) -> float:
    """PEFT adapter scaling: alpha/r, or alpha/sqrt(r) under rsLoRA.
    Per-module rank_pattern/alpha_pattern overrides change the scale per
    target: refused rather than silently mis-scaled."""
    if acfg.get("rank_pattern") or acfg.get("alpha_pattern"):
        raise ValueError("adapters with rank_pattern/alpha_pattern are not supported")
    r = float(acfg.get("r", 8))
    alpha = float(acfg.get("lora_alpha", 16))
    if acfg.get("use_rslora"):
        return alpha / math.sqrt(r)
    return alpha / r


def add_lora(
    params: Any,
    generator: torch.Generator,
    *,
    rank: int = 128,
    alpha: float = 256.0,
    targets: Sequence[str] = tuple(DEFAULT_TARGETS),
    dtype=None,
    place=None,
) -> Any:
    """Wrap matching weight leaves with fresh adapters: A normal scaled by
    ``in**-0.5``, B zero (the adapter starts as the identity). Defaults as
    scripts/v1_5/finetune_lora.sh (rank 128, alpha 256). An already wrapped
    leaf is left as it is. ``generator`` draws the A matrices (its own
    device's generator: the numbers differ from the JAX package's), each
    whole, so a sharded base gets the draws of one device.
    ``place(path, wrapper)`` takes each new wrapper before the next A is
    drawn (over a mesh, ``parallel.leaf_sharder``: a rank keeps its shards
    of ``a`` and ``b``)."""
    patterns = [re.compile(p) for p in targets]

    def leaf(path, x):
        if not any(p.match(path) for p in patterns) or isinstance(x, LoraWeight):
            return x
        lead, in_dim, out_dim = tuple(x.shape[:-2]), x.shape[-2], x.shape[-1]
        if dtype is not None:
            dt = dtype
        elif isinstance(x, QuantizedTensor):
            dt = torch.bfloat16  # adapters cannot train in the base's int8
        else:
            dt = x.dtype
        dev = _device(x)
        a = torch.randn(lead + (in_dim, rank), generator=generator, device=dev, dtype=dt)
        a = a * torch.tensor(in_dim**-0.5, dtype=dt, device=dev)
        b = torch.zeros(lead + (rank, out_dim), dtype=dt, device=dev)
        w = LoraWeight(base=x, a=a, b=b, scale=float(alpha) / rank)
        return w if place is None else place(path, w)

    return _map_with_path(params, leaf)


def _fold(base, a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """``base + scale * a @ b`` in f32, rounded to the base's dtype (a
    quantized base dequantized to ``a``'s)."""
    if isinstance(base, QuantizedTensor):
        base = dequantize(base, dtype=a.dtype)
    delta = torch.einsum("...ir,...ro->...io", a.float(), b.float()) * scale
    return (base.float() + delta).to(base.dtype)


def _merged_layers(x: LoraWeight) -> torch.Tensor:
    """:func:`_fold` of a wrapper on one device. A layer-stacked leaf is
    folded a layer at a time into one tensor of the merged dtype, so the f32
    transients are one layer's (a 13B ``gate_proj`` stack is 10.5 GiB in
    f32); the numbers are the whole-stack fold's."""
    if x.base.ndim < 3:
        return _fold(x.base, x.a, x.b, x.scale)
    dtype = x.a.dtype if isinstance(x.base, QuantizedTensor) else x.base.dtype
    merged = torch.empty(x.base.shape, dtype=dtype, device=_device(x.base))
    for l in range(x.base.shape[0]):
        merged[l] = _fold(x.base[l], x.a[l], x.b[l], x.scale)
    return merged


def _merged_shard(x: LoraWeight, stored):
    """This rank's shard of ``x``'s merged weight, a DTensor placed as
    ``stored`` (the base's stored DTensor): a stacked leaf's layers are
    gathered whole, folded and cut to this rank's block one at a time."""
    from torch.distributed.tensor import DTensor, Shard

    # parallel/sharding.py imports this module.
    from vcoder_tpu_torch.parallel.sharding import local_block, whole_layer

    dm, placements, shape = stored.device_mesh, stored.placements, tuple(x.base.shape)
    if len(shape) == 2:
        merged = _fold(_whole(x.base), _whole(x.a), _whole(x.b), x.scale)
        local = local_block(merged, dm, placements).clone(memory_format=torch.contiguous_format)
    else:
        inner = [Shard(p.dim - 1) if p.is_shard() else p for p in placements]
        local = None
        for l in range(shape[0]):
            base = x.base
            if isinstance(base, QuantizedTensor):
                base = QuantizedTensor(whole_layer(base.q, l), whole_layer(base.scale, l), base.bits)
            else:
                base = whole_layer(base, l)
            block = local_block(_fold(base, whole_layer(x.a, l), whole_layer(x.b, l), x.scale),
                                dm, inner)
            if local is None:
                local = torch.empty((shape[0], *block.shape), dtype=block.dtype,
                                    device=block.device)
            local[l] = block
    return DTensor.from_local(local, dm, placements, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def merge_lora(params: Any) -> Any:
    """Fold every LoraWeight into a plain dense weight (PEFT
    ``merge_and_unload``), a stacked leaf one layer at a time
    (:func:`_merged_layers`), so the merge holds the merged weights and one
    layer's f32 transients beside its input. Over a mesh every rank calls
    this: the merged weight comes back as this rank's shard of it, placed as
    the stored weight was, built one layer at a time
    (:func:`_merged_shard`), so a rank holds its shards and one layer's
    whole fields and f32 transients at a time."""

    @torch.no_grad()
    def leaf(_path, x):
        if not isinstance(x, LoraWeight):
            return x
        stored = x.base.q if isinstance(x.base, QuantizedTensor) else x.base
        if _is_dtensor(stored):
            return _merged_shard(x, stored)
        return _merged_layers(x)

    return _map_with_path(params, leaf)


def lora_partial(x: torch.Tensor, w: LoraWeight, matmul) -> torch.Tensor:
    """One rank's share of the LoRA term ``scale * (x @ a) @ b`` in a
    product whose contraction is split over ranks (its input columns, its
    rows of ``a``, ``b`` whole), ``matmul`` computing the outer product
    (``spmd.partial_product``: f32 where it has an f32 form)."""
    return _scalar(w.scale, x.dtype) * matmul(x @ w.a.to(x.dtype), w.b.to(x.dtype))


def _scalar(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as ``jnp.asarray(value, dtype)``."""
    return float(torch.tensor(value, dtype=dtype))


def lora_qmatmul(x: torch.Tensor, w: LoraWeight) -> torch.Tensor:
    """``x @ W_eff`` without the merged matrix."""
    y = qmatmul(x, w.base)
    lo = (x @ w.a.to(x.dtype)) @ w.b.to(x.dtype)
    return y + _scalar(w.scale, x.dtype) * lo


def multilora_qmatmul(x: torch.Tensor, w: MultiLoraWeight) -> torch.Tensor:
    """``x @ W_eff`` with a per-row adapter: row b gathers its ``[in, R]`` /
    ``[R, out]`` factors from the stacks. x: ``[B, T, in]`` (decode T=1,
    verify T=k); w one layer's slice (idx ``[B]``)."""
    y = qmatmul(x, w.base)
    idx = w.idx.long()
    a = w.a[idx].to(x.dtype)  # [B, in, R]
    b = w.b[idx].to(x.dtype)  # [B, R, out]
    lo = torch.einsum("bti,bir->btr", x, a)
    return y + torch.einsum("btr,bro->bto", lo, b)


def extract_adapters(tree: Any) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, float]]:
    """``{path: (a, b, scale)}`` for every LoraWeight of a parameter tree
    (what :func:`add_lora` or training produce), sharded fields gathered
    whole one adapter at a time (every rank of a mesh calls this). A dict of
    that shape passes through unchanged."""
    if isinstance(tree, dict) and tree and all(
        isinstance(v, tuple) and len(v) == 3 for v in tree.values()
    ):
        return dict(tree)
    out = {}

    def leaf(path, x):
        if isinstance(x, LoraWeight):
            out[path] = (_whole(x.a), _whole(x.b), x.scale)
        return x

    _map_with_path(tree, leaf)
    return out


def stack_adapters(params: Any, adapters: Dict[str, Any], max_batch: int):
    """The multi-adapter serving tree: every weight path an adapter targets
    becomes a MultiLoraWeight whose stacks hold ``[zero, adapter_1, ...,
    adapter_n]`` (adapters sorted by name), ranks zero-padded to the largest
    and each adapter's alpha/r folded into its b, on the base's device.
    Returns ``(wrapped_params, {name: index})``; index 0 means no adapter."""
    names = sorted(adapters)
    trees = {n: extract_adapters(adapters[n]) for n in names}
    for n in names:
        if not trees[n]:
            raise ValueError(f"adapter {n!r} has no LoRA targets")
    paths = sorted({p for t in trees.values() for p in t})
    if not paths:
        raise ValueError("no LoRA targets found in any adapter")
    name_to_idx = {n: i + 1 for i, n in enumerate(names)}
    wrapped_paths = set()

    def wrap(path, x):
        if path not in paths:
            return x
        wrapped_paths.add(path)
        in_dim, out_dim = x.shape[-2], x.shape[-1]
        if x.ndim != 3:
            # multilora_qmatmul gathers per-layer factors.
            raise ValueError(
                f"multi-LoRA target {path} must be layer-stacked [L, in, out]; "
                f"got shape {tuple(x.shape)}"
            )
        L = x.shape[0]
        entries = [trees[n].get(path) for n in names]
        for n, e in zip(names, entries):
            if e is None:
                continue
            got = e[0].shape[0] if e[0].ndim == 3 else 1
            if got != L or e[0].shape[-2] != in_dim:
                raise ValueError(
                    f"adapter {n!r} at {path}: A is {tuple(e[0].shape)} but the base "
                    f"weight is stacked over {L} layers with in_dim {in_dim} -- a "
                    f"partial-layer adapter (layers_to_transform) is not supported"
                )
            if e[1].shape[-1] != out_dim:
                raise ValueError(
                    f"adapter {n!r} at {path}: B is {tuple(e[1].shape)} but the base "
                    f"weight's out_dim is {out_dim} (adapter trained on a different "
                    f"architecture?)"
                )
        R = max(e[0].shape[-1] for e in entries if e is not None)
        dt = next(e[0].dtype for e in entries if e is not None)
        dev = _device(x)
        a_stack = [torch.zeros((L, in_dim, R), dtype=dt, device=dev)]
        b_stack = [torch.zeros((L, R, out_dim), dtype=dt, device=dev)]
        for e in entries:
            if e is None:
                a_stack.append(torch.zeros((L, in_dim, R), dtype=dt, device=dev))
                b_stack.append(torch.zeros((L, R, out_dim), dtype=dt, device=dev))
                continue
            a, b, scale = e
            a = torch.as_tensor(a).to(dev).reshape(L, in_dim, -1).to(dt)
            b = (torch.as_tensor(b).to(dev).reshape(L, -1, out_dim).float()
                 * float(scale)).to(dt)
            r = a.shape[-1]
            a_stack.append(torch.nn.functional.pad(a, (0, R - r)))
            b_stack.append(torch.nn.functional.pad(b, (0, 0, 0, R - r)))
        return MultiLoraWeight(
            base=x,
            a=torch.stack(a_stack, dim=1),  # [L, n+1, in, R]
            b=torch.stack(b_stack, dim=1),
            idx=torch.zeros((L, max_batch), dtype=torch.int32, device=dev),
        )

    wrapped = _map_with_path(params, wrap)
    # An adapter none of whose paths exist here would serve as the base model.
    for n in names:
        if not (set(trees[n]) & wrapped_paths):
            raise ValueError(
                f"adapter {n!r} targets no parameter of this model "
                f"(paths: {sorted(trees[n])[:4]}...)"
            )
    return wrapped, name_to_idx


def _multi_leaves(tree):
    out = []

    def leaf(_path, x):
        if isinstance(x, MultiLoraWeight):
            out.append(x)
        return x

    _map_with_path(tree, leaf)
    return out


def set_row_adapter(params: Any, slot: int, adapter_idx: int) -> Any:
    """Point batch row ``slot`` at adapter ``adapter_idx`` (0 = none): writes
    the ``[L, B]`` index of every MultiLoraWeight in place (a fill on the
    device, no host sync). Returns ``params``."""
    for w in _multi_leaves(params):
        w.idx[:, slot] = adapter_idx
    return params


def single_adapter_view(params: Any, adapter_idx: int) -> Any:
    """B=1 prefill view: adapter ``adapter_idx`` sliced out of every
    MultiLoraWeight as a LoraWeight (scale already folded into b). Index 0
    slices the zero adapter, so the view has the same structure with or
    without an adapter. Shares the base and the stacks (views, no copy)."""

    def leaf(_path, x):
        if isinstance(x, MultiLoraWeight):
            return LoraWeight(base=x.base, a=x.a[:, adapter_idx], b=x.b[:, adapter_idx],
                              scale=1.0)
        return x

    return _map_with_path(params, leaf)


def read_adapter_state(model_path: str) -> Dict[str, torch.Tensor]:
    """The tensors of ``adapter_model.safetensors`` (the port's own reader)
    or ``adapter_model.bin`` (``torch.load``, ``weights_only``)."""
    from vcoder_tpu_torch.checkpoint import read_safetensors

    for cand in ("adapter_model.safetensors", "adapter_model.bin"):
        p = os.path.join(model_path, cand)
        if not os.path.exists(p):
            continue
        if cand.endswith(".safetensors"):
            return read_safetensors(p)
        return torch.load(p, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"No adapter_model.* in {model_path}")


def read_adapter_config(model_path: str) -> dict:
    path = os.path.join(model_path, "adapter_config.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_lora_adapter_dir(model_path: str) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, float]]:
    """A PEFT-format adapter directory -> ``{path: (a, b, scale)}`` WITHOUT
    merging (the multi-LoRA serving input; ``checkpoint.load_lora_checkpoint``
    is the merge path). HF keys ``...model.layers.{i}.self_attn.q_proj
    .lora_A.weight`` ``[r, in]`` / ``lora_B`` ``[out, r]`` stack to
    ``[L, in, r]`` / ``[L, r, out]`` CPU tensors."""
    scale = adapter_scale(read_adapter_config(model_path))
    state = read_adapter_state(model_path)
    per_proj: dict = {}
    pat = re.compile(r"layers\.(\d+)\.(?:self_attn|mlp)\.(\w+_proj)\.lora_([AB])\.weight$")
    skipped = []
    for key, v in state.items():
        m = pat.search(key)
        if m is None:
            if "lora_" in key or "modules_to_save" in key:
                skipped.append(key)
            continue
        li, proj, ab = int(m.group(1)), m.group(2), m.group(3)
        per_proj.setdefault(proj, {}).setdefault(ab, {})[li] = v
    if skipped:
        # A half-applied adapter degrades outputs silently: say so.
        logging.getLogger("vcoder_tpu_torch").warning(
            "load_lora_adapter_dir(%s): %d adapter tensors target unsupported modules "
            "and were skipped (e.g. %s)", model_path, len(skipped), skipped[0],
        )
    out = {}
    for proj, mats in per_proj.items():
        if set(mats.get("A", {})) != set(mats.get("B", {})):
            raise ValueError(
                f"{model_path}: {proj} lora_A/lora_B cover different layers "
                f"({sorted(mats.get('A', {}))} vs {sorted(mats.get('B', {}))})"
            )
        layers = sorted(mats["A"])
        a = torch.stack([mats["A"][i].t() for i in layers]).contiguous()
        b = torch.stack([mats["B"][i].t() for i in layers]).contiguous()
        out[f"lm/layers/{proj}"] = (a, b, scale)
    return out
