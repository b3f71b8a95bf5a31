"""The model's forward over a distributed mesh (port-only; the analog of
GSPMD partitioning the JAX package's jitted graphs and ``shard_map``-ing its
Pallas calls).

Every rank runs the same forward on its part of the work:

* **Weights** live as DTensors by ``parallel/sharding.py``'s rules. Each is
  gathered over ``data`` and ``fsdp`` where it is used, one decoder or tower
  layer at a time (ZeRO-3), and keeps its ``model`` split; its gradient
  goes back as a partial sum over the row axes, which DTensor reduces
  (reduce-scatter over ``fsdp``, all-reduce over ``data``). Only the
  tower's weights are gathered over ``model``.
* **Tensor parallelism** over ``model`` is Megatron's, in the decoder: the
  q/k/v and gate/up products keep their output columns' shard, so
  attention runs on this rank's heads; the o/down products take the
  matching input rows and sum their f32 partials over ``model``. A block
  whose heads (or MLP width) the axis does not divide replicates its
  weights over ``model`` instead, and so does the whole vision tower
  (``models/clip.py`` says why). The vocabulary products (embedding
  lookups, the LM head) gather their activations over ``model``.
* **Wrapped weights.** A quantized or LoRA-wrapped weight is computed field
  by field, each field gathered over ``data x fsdp`` and split over
  ``model`` as the product needs it: ``q`` as the weight; a scale keeps its
  local columns in a column-parallel product and is whole in a row-parallel
  one; a LoRA ``a`` is whole for column-parallel products and split on its
  input rows for row-parallel ones, its ``b`` the reverse. A row-parallel
  product sums f32 partials over ``model`` for every form but W8A8, whose
  s32 products are summed exactly (``ops/quant.py``); a LoRA term is part
  of the partial sum.
* **Rows.** A training batch is split over ``data x fsdp`` before the
  forward (``shard_batch``); the engines' caches and page pools hold each
  rank's rows, and the decoder slices a step's rows to them and gathers the
  hidden states back, so every value the host reads is replicated and the
  ranks cannot diverge. A B=1 prefill runs on every rank.

Without a distributed mesh every helper is the identity, so the model code
calls them unconditionally.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch
import torch.distributed as dist

from vcoder_tpu_torch.lora import LoraWeight, MultiLoraWeight, lora_partial
from vcoder_tpu_torch.ops import quant
from vcoder_tpu_torch.ops.quant import QuantizedTensor
from vcoder_tpu_torch.parallel.mesh import Mesh, distributed_mesh

_TLS = threading.local()


def mesh() -> Optional[Mesh]:
    return distributed_mesh()


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


@contextlib.contextmanager
def local_rows(rows: bool = True):
    """Within: the activations hold this rank's rows of a batch split over
    ``data x fsdp`` (a training step, an engine's decode over its slots);
    ``rows=False``: every row of their batch."""
    prev = getattr(_TLS, "rows", False)
    _TLS.rows = rows
    try:
        yield
    finally:
        _TLS.rows = prev


def rows_are_local() -> bool:
    return getattr(_TLS, "rows", False)


def capture():
    """This thread's SPMD state (the distributed mesh and the rows flag),
    for :func:`restore` in code that may run again on another thread: a
    checkpointed layer's recompute runs in autograd's device thread."""
    return mesh(), rows_are_local()


@contextlib.contextmanager
def restore(state):
    from vcoder_tpu_torch.parallel.mesh import use_mesh

    m, rows = state
    with use_mesh(m) if m is not None else contextlib.nullcontext(), local_rows(rows):
        yield


def global_rows(b_local: int) -> int:
    """The batch a forward's ``b_local`` rows belong to."""
    m = mesh()
    return b_local * m.row_shards if m is not None and rows_are_local() else b_local


# ---- collectives over the model axis (autograd-aware) ----


def _model_group(m: Mesh):
    return m.device_mesh.get_group("model")


def model_size() -> int:
    m = mesh()
    return 1 if m is None else m.shape["model"]


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n = dist.get_world_size(group)
        ctx.dim, ctx.rank, ctx.n = dim, dist.get_rank(group), n
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        # The gathered activation feeds identical work on every model rank,
        # so each keeps its own slice of the (identical) gradient.
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous(), None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``model`` (the input of
    column-parallel products)."""
    m = mesh()
    if m is None or m.shape["model"] == 1:
        return x
    return _CopyToModel.apply(x, _model_group(m))


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Sum over ``model`` (the output of row-parallel products)."""
    m = mesh()
    if m is None or m.shape["model"] == 1:
        return x
    return _ReduceFromModel.apply(x, _model_group(m))


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 accumulation and an f32 result."""
    part = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return part.reshape(*x.shape[:-1], w.shape[-1])


def partial_product(x: torch.Tensor, w, matmul) -> torch.Tensor:
    """``matmul(x, w)`` as one rank's partial sum of a product whose
    contraction is split over ``model``. Without autograd through it,
    half-precision operands on CUDA give an f32 partial, so the sum over
    ``model`` is rounded once, as one device's product is. A quantized
    weight below the W8A8 threshold gives an f32 partial always, its scale
    first rounded to ``x``'s dtype as one device's product multiplies it:
    the int8 upcast on CUDA as the half-precision product above times the
    scale, anything else ``qmatmul`` on f32 activations (int4 on CUDA: K5,
    which rounds them to bf16 as always and writes its f32 sums times the
    scale). Otherwise the product in ``matmul``'s dtype."""
    half = x.is_cuda and x.dtype in (torch.bfloat16, torch.float16)
    if isinstance(w, QuantizedTensor):
        scale = w.scale.to(x.dtype).float()
        if half and w.bits == 8 and not _needs_grad(x):
            return _mm_f32(x, w.q.to(x.dtype)) * scale
        return quant.qmatmul(x.float(), QuantizedTensor(w.q, scale, w.bits))
    if half and x.dtype == w.dtype and not _needs_grad(x, w):
        return _mm_f32(x, w)
    return matmul(x, w)


def row_parallel(x: torch.Tensor, w, matmul) -> torch.Tensor:
    """``matmul(x, w)`` for a product whose contraction is split over
    ``model`` (this rank's input columns and weight rows): the
    :func:`partial_product` added over ``model``, in ``x``'s dtype. A W8A8
    base reduces its exact s32 products itself (``quant.w8a8_matmul``); a
    LoRA's term ``scale * (x @ a) @ b`` over this rank's rows of ``a`` (``b``
    whole) is added to the partial sum before the reduction."""
    base, lora = (w.base, w) if isinstance(w, LoraWeight) else (w, None)
    whole, part = None, None
    if quant.uses_w8a8(x, base):
        whole = quant.w8a8_matmul(x, base, group=_model_group(mesh()))
    else:
        part = partial_product(x, base, matmul)
    if lora is not None:
        lo = lora_partial(x, lora, lambda t, b: partial_product(t, b, matmul))
        part = lo if part is None else part + lo.to(part.dtype)
    if part is None:
        return whole
    out = reduce_from_model(part).to(x.dtype)
    return out if whole is None else whole + out


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Concatenate every model rank's ``x`` along ``dim``."""
    m = mesh()
    if m is None or m.shape["model"] == 1:
        return x
    return _GatherFromModel.apply(x, dim % x.ndim, _model_group(m))


# ---- weights ----


def _base_tensor(w):
    """The stored weight under any wrappers (a quantized weight's ``q``)."""
    while isinstance(w, (LoraWeight, MultiLoraWeight)):
        w = w.base
    return w.q if isinstance(w, QuantizedTensor) else w


def _model_dim(w) -> Optional[int]:
    """The tensor dimension a DTensor (a wrapped weight's stored weight)
    shards over ``model``, else None."""
    m = mesh()
    w = _base_tensor(w)
    if m is None or not _is_dtensor(w):
        return None
    p = w.placements[m.axis_names.index("model")]
    return p.dim if p.is_shard() else None


def is_sharded(w) -> bool:
    """A DTensor, or a wrapper whose stored weight is one."""
    return _is_dtensor(_base_tensor(w))


def weight(w, model_dim: Optional[int] = -1, index: Optional[int] = None,
           partial_grad: bool = False):
    """The compute tensor of one weight (of ``w[index]``, a layer of a
    layer-stacked weight, when ``index`` is given): gathered over ``data``
    and ``fsdp``; over ``model`` split along ``model_dim`` (-1: as stored;
    None: replicated). A plain tensor passes through; a quantized or LoRA
    wrapper comes back with each field's compute tensor
    (:func:`_wrapped_weight`). Without autograd through it,
    this rank's shard is gathered by plain collectives over
    each mesh dimension's group (where nothing needs gathering, the shard
    is the tensor); under autograd through DTensor, whose backward sends
    the gradient back as a partial sum over the row axes (and over
    ``model`` too with ``partial_grad``: a whole weight that each model
    rank applies to its own share of a product)."""
    if isinstance(w, (QuantizedTensor, LoraWeight, MultiLoraWeight)):
        return _wrapped_weight(w, model_dim, index)
    if not _is_dtensor(w):
        return w if index is None else w[index]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    m = mesh()
    sizes = m.devices.shape
    mi = m.axis_names.index("model")
    src = list(w.placements)
    if index is not None:  # layer stacks are never split along the layer axis
        src = [Shard(p.dim - 1) if p.is_shard() else p for p in src]
    # A placement over a mesh dimension of size 1 is no split at all.
    src = [Replicate() if sizes[i] == 1 else p for i, p in enumerate(src)]
    if model_dim == -1:
        model_p = src[mi]
    else:
        model_p = Replicate() if model_dim is None or sizes[mi] == 1 else Shard(model_dim)
    target = [Replicate()] * 3
    target[mi] = model_p
    if not (torch.is_grad_enabled() and w.requires_grad):
        with torch.no_grad():
            local = w.to_local()
            return _relayout(local if index is None else local[index], src, target, m)
    if index is not None:
        shape = w.shape[1:]
        w = DTensor.from_local(w.to_local(grad_placements=w.placements)[index], w.device_mesh,
                               [Shard(p.dim - 1) if p.is_shard() else p for p in w.placements],
                               run_check=False, shape=shape,
                               stride=torch.empty(shape, device="meta").stride())
    # The gradient: a partial sum over the row dimensions that split rows.
    grads = [Partial() if n > 1 else Replicate() for n in sizes]
    grads[mi] = Partial() if partial_grad and sizes[mi] > 1 else model_p
    if list(w.placements) != target:
        w = w.redistribute(m.device_mesh, target)
    return w.to_local(grad_placements=grads)


def _wrapped_weight(w, model_dim, index):
    """:func:`weight` of each field of a wrapper. In a product split over
    ``model`` by its input rows (``model_dim`` the slice's row axis) or its
    output columns (the last axis): ``q`` and a LoRA base as the weight; a
    scale ``[.., 1, out]`` keeps the columns, whole for rows; a LoRA ``a``
    keeps the rows, whole for columns, where each rank's gradient of it is
    a partial sum; ``b`` the reverse. A multi-LoRA stack over a mesh
    raises JAX's ``ValueError``."""
    if isinstance(w, MultiLoraWeight):
        if mesh() is not None:
            raise ValueError("multi-LoRA serving is single-device only")
        return w if index is None else w[index]
    if model_dim == -1:
        model_dim = _model_dim(w)
        if model_dim is not None and index is not None:
            model_dim -= 1
    ndim = _base_tensor(w).ndim - (index is not None)
    rows = model_dim is not None and model_dim == ndim - 2
    cols = model_dim is not None and model_dim == ndim - 1
    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(weight(w.q, model_dim, index),
                               weight(w.scale, model_dim if cols else None, index), w.bits)
    return LoraWeight(weight(w.base, model_dim, index),
                      weight(w.a, model_dim if rows else None, index, partial_grad=cols),
                      weight(w.b, model_dim if cols else None, index, partial_grad=rows),
                      w.scale)


def _relayout(local: torch.Tensor, src, target, m: Mesh) -> torch.Tensor:
    """This rank's part of a tensor placed ``src`` turned into its part
    placed ``target``, mesh dimension by dimension: a gather where ``src``
    splits and ``target`` does not (in the group's rank order, as DTensor
    splits), a slice where ``target`` splits and ``src`` does not."""
    for i, (a, b) in enumerate(zip(src, target)):
        if a == b:
            continue
        axis = m.axis_names[i]
        n = m.devices.shape[i]
        if a.is_shard() and b.is_replicate():
            group = m.device_mesh.get_group(axis)
            parts = [torch.empty_like(local) for _ in range(n)]
            dist.all_gather(parts, local.contiguous(), group=group)
            local = torch.cat(parts, dim=a.dim)
        elif a.is_replicate() and b.is_shard():
            local = local.chunk(n, dim=b.dim)[m.local_rank(axis)]
        else:
            raise ValueError(f"no relayout from {a} to {b} over {axis}")
    return local


# The decoder's per-layer compute splits over ``model``: (block, dim of the
# layer slice).
_LLAMA_SPLIT = {
    "q_proj": ("attn", 1), "k_proj": ("attn", 1), "v_proj": ("attn", 1), "o_proj": ("attn", 0),
    "gate_proj": ("mlp", 1), "up_proj": ("mlp", 1), "down_proj": ("mlp", 0),
}


def tp_blocks(heads, width: int) -> Dict[str, bool]:
    """Which blocks split over ``model``: attention when it divides every
    head count in ``heads``, the MLP when it divides ``width``."""
    n = model_size()
    return {"attn": n > 1 and all(h % n == 0 for h in heads), "mlp": n > 1 and width % n == 0}


def local_heads(h: int, heads) -> int:
    """This rank's share of ``h`` heads of a decoder whose attention heads
    are ``heads`` (q and kv)."""
    return h // model_size() if tp_blocks(heads, 1)["attn"] else h


def layer(stack: dict, l: int, *, heads=None, width: int = 0) -> dict:
    """Layer ``l`` of a layer-stacked weight dict as compute tensors. With
    the decoder's ``heads`` (q and kv) and MLP ``width`` its blocks split
    over ``model`` where the axis divides them, and ``tp_attn`` / ``tp_mlp``
    say which (their outputs need :func:`row_parallel`); without them (the
    tower) every weight is gathered whole and the layer runs replicated over
    ``model``."""
    m = mesh()
    if m is None:
        return {k: v[l] for k, v in stack.items()}
    tp = tp_blocks(heads, width) if heads else {"attn": False, "mlp": False}
    out = {}
    for k, v in stack.items():
        if not is_sharded(v):
            raise ValueError(f"layer weight {k} is not sharded over the mesh "
                             "(parallel.shard_params)")
        block, dim = _LLAMA_SPLIT.get(k, (None, None)) if heads else (None, None)
        out[k] = weight(v, dim if block and tp[block] else None, index=l)
    out["tp_attn"], out["tp_mlp"] = tp["attn"], tp["mlp"]
    return out


def embed(table, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for an embedding table ``[V, D]`` (columns split over
    ``model``: the lookup is gathered)."""
    split = _model_dim(table) == 1
    out = weight(table)[ids]
    return gather_from_model(out, -1) if split else out


def column_product(hidden: torch.Tensor, w, matmul) -> torch.Tensor:
    """``matmul(hidden, w)`` for a projection ``[D, N]`` whose output columns
    (the LM head's vocabulary) may be split over ``model``: the local
    columns are gathered."""
    if _model_dim(w) != 1:
        return matmul(hidden, weight(w))
    return gather_from_model(matmul(copy_to_model(hidden), weight(w)), -1)


# ---- rows ----


def row_slice(b: int) -> slice:
    """This rank's rows of a batch of ``b`` split over ``data x fsdp``."""
    m = mesh()
    n = m.row_shards
    if b % n:
        raise ValueError(f"{b} rows over {n} row shards")
    per = b // n
    return slice(m.row_index * per, (m.row_index + 1) * per)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Concatenate every row shard's ``x`` along dim 0 (no autograd)."""
    m = mesh()
    if m.row_shards == 1:
        return x
    group = m.rows_mesh.get_group()
    parts = [torch.empty_like(x) for _ in range(m.row_shards)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the row shards (no autograd)."""
    m = mesh()
    if m.row_shards == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=m.rows_mesh.get_group())
    return x
