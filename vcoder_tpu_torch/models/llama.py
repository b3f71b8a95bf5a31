"""Llama (Vicuna v1.5) decoder (port of ``vcoder_tpu/models/llama.py``).

* Parameters keep the JAX package's layer-stacked dict: matrices
  ``[L, in, out]`` (``x @ W``), norms ``[L, D]``; a Python loop over layers
  replaces ``lax.scan``. A matrix may be an int8/int4 ``QuantizedTensor``
  (``ops/quant.py``): every product goes through ``qmatmul``, a layer's
  slice is ``leaf[l]`` and ``L`` its logical ``shape[0]``.
* RMSNorm normalizes in f32, casts to the input dtype, then multiplies by the
  weight (``llama.py:85-91``); RoPE is rotate-half over f32 positions
  (``:94-114``).
* :func:`llama_paged_decode` / :func:`llama_paged_verify` (``:392,576``) run
  the same layers over KV page pools (``ops/paged_attention.py``), bf16 or
  int8 with scales from :func:`_kv_quantize` (``:178``); the pools are
  written in place.
* Over a distributed mesh (``parallel/spmd.py``) each layer's weights are
  gathered over ``data x fsdp`` at use and its attention heads and MLP
  width split over ``model`` (Megatron tensor parallelism); a cache or page
  pool holds this rank's rows and heads, the step's rows are sliced to
  them and the hidden states gathered back, and the page table's global
  ids are rebased to the rank's pools once a step before the same paged
  kernels run (JAX's ``sharded_*`` wrappers, ``:437-470,638-680``).
  Quantized and LoRA-wrapped weights split the same way, field by field;
  the o/down products of a quantized or LoRA weight reduce as
  ``spmd.row_parallel`` says.
  With ``ops.paged_attention.FUSED_APPEND`` (read at call time) a decode step and a verify window of at most 16 tokens append and
  attend in one kernel per layer (``:507-540,628``); otherwise the writers
  append and the paged kernel attends.
* ``llama_forward(remat=...)`` (``:203,347-357``) checkpoints each layer of
  the cache-free (training) path: ``True`` recomputes the whole layer in the
  backward, ``"dots"`` keeps the projection products and recomputes the rest
  (the analog of ``dots_with_no_batch_dims_saveable``).
* The dense :class:`KVCache` (``:122-168``) is updated IN PLACE: each
  layer's new K/V rows are written into the preallocated ``[L, B, S, KH,
  HD]`` tensors (JAX's functional carry is no model for PyTorch). Writes
  land at ``write_offset + arange(T)`` per row (``:249-258``); ``kv_mask``
  marks only ``[offset, offset + n_valid)`` (``:234-239``); pad rows write
  garbage that ``kv_mask`` never marks and a later write at the same slot
  overwrites. A quantized cache (``create(quantized=True)``) holds int8 K/V
  and f32 per-vector scales ``[L, B, S, KH, 1]``: each layer quantizes its
  K/V with :func:`_kv_quantize` and writes values and scales; a window of at
  most ``QUANT_FOLD_T_MAX`` tokens attends with the scales folded into the
  plain route, a longer one (a prefill) over the layer's dequantized copy on
  the flash route (``:272-308``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from vcoder_tpu_torch.config import TextConfig
from vcoder_tpu_torch.ops.attention import multi_head_attention
from vcoder_tpu_torch.ops.quant import qmatmul as qm
from vcoder_tpu_torch.parallel import spmd


def init_llama_params(
    generator: torch.Generator, cfg: TextConfig, *, dtype=torch.float32, device="cpu",
    place=None,
) -> dict:
    """Random-normal (0.02) init, layer-stacked, sampled directly in ``dtype``
    on ``device`` (no f32 intermediate at 7B). ``place(path, leaf)``, when
    given, takes each leaf as it is drawn (``parallel.leaf_sharder``)."""
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, KH, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    V = cfg.vocab_size
    put = place or (lambda _path, t: t)

    def nrm(path, *shape):
        return put(path, torch.randn(shape, generator=generator, dtype=dtype,
                                     device=device).mul_(0.02))

    def ones(path, *shape):
        return put(path, torch.ones(shape, dtype=dtype, device=device))

    return {
        "embed_tokens": nrm("embed_tokens", V, D),
        "layers": {
            "input_layernorm": ones("layers/input_layernorm", L, D),
            "post_attention_layernorm": ones("layers/post_attention_layernorm", L, D),
            "q_proj": nrm("layers/q_proj", L, D, H * HD),
            "k_proj": nrm("layers/k_proj", L, D, KH * HD),
            "v_proj": nrm("layers/v_proj", L, D, KH * HD),
            "o_proj": nrm("layers/o_proj", L, H * HD, D),
            "gate_proj": nrm("layers/gate_proj", L, D, I),
            "up_proj": nrm("layers/up_proj", L, D, I),
            "down_proj": nrm("layers/down_proj", L, I, D),
        },
        "norm": ones("norm", D),
        "lm_head": nrm("lm_head", D, V),
    }


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return x.to(dtype) * weight


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-convention rotary tables: positions [B, T] -> cos/sin [B, T, head_dim]."""
    inv_freq = 1.0 / (
        theta
        ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim)
    )
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, D]; cos/sin: [B, T, D] (rotate-half)."""
    d2 = x.shape[-1] // 2
    rotated = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    out = x * cos[:, :, None, :] + rotated * sin[:, :, None, :]
    return out.to(x.dtype)


@dataclasses.dataclass
class KVCache:
    """Static-size dense KV cache.

    k, v: [L, B, S_max, KH, HD]; kv_mask: [B, S_max] validity of each slot;
    length: [B] populated slots per row. Quantized (``k_scale`` given): k/v
    hold int8 and k_scale/v_scale the f32 per-vector scales [L, B, S_max, KH,
    1]; values dequantize at the attention read. Over a distributed mesh
    k/v (and their scales) hold this rank's rows and KV heads; kv_mask and
    length cover every row on every rank.
    """

    k: torch.Tensor
    v: torch.Tensor
    kv_mask: torch.Tensor
    length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def create(
        cfg: TextConfig, batch: int, max_len: int, *, dtype=torch.float32, device="cpu",
        quantized: bool = False, rows: Optional[int] = None,
    ) -> "KVCache":
        """``rows``: the rows k/v hold (default ``batch``; this rank's share
        of them over a mesh). KV heads are this rank's share."""
        L, HD = cfg.num_layers, cfg.head_dim
        KH = local_kv_heads(cfg)
        kv_dtype = torch.int8 if quantized else dtype
        n = batch if rows is None else rows

        def zeros(last, dt):
            return torch.zeros((L, n, max_len, KH, last), dtype=dt, device=device)

        return KVCache(
            k=zeros(HD, kv_dtype),
            v=zeros(HD, kv_dtype),
            kv_mask=torch.zeros((batch, max_len), dtype=torch.bool, device=device),
            length=torch.zeros((batch,), dtype=torch.int64, device=device),
            k_scale=zeros(1, torch.float32) if quantized else None,
            v_scale=zeros(1, torch.float32) if quantized else None,
        )


def local_kv_heads(cfg: TextConfig) -> int:
    """The KV heads a cache or page pool holds on this rank."""
    return spmd.local_heads(cfg.num_kv_heads, (cfg.num_heads, cfg.num_kv_heads))


def layer_weights(layers: dict, l: int, cfg: TextConfig) -> dict:
    """Layer ``l``'s weights as compute tensors (``parallel/spmd.py``)."""
    return spmd.layer(layers, l, heads=(cfg.num_heads, cfg.num_kv_heads),
                      width=cfg.intermediate_size)


def _layer_qkv(lp: dict, cfg: TextConfig, x: torch.Tensor, cos, sin):
    """RMSNorm, q/k/v projections and RoPE of one layer: (q, k, v) as
    [B, T, H|KH, HD] (this rank's heads over a mesh)."""
    B, T, _ = x.shape
    HD = cfg.head_dim
    h = rms_norm(x, lp["input_layernorm"], cfg.rms_norm_eps)
    if lp.get("tp_attn"):
        h = spmd.copy_to_model(h)
    q = apply_rope(qm(h, lp["q_proj"]).reshape(B, T, -1, HD), cos, sin)
    k = apply_rope(qm(h, lp["k_proj"]).reshape(B, T, -1, HD), cos, sin)
    v = qm(h, lp["v_proj"]).reshape(B, T, -1, HD)
    return q, k, v


def _layer_out(lp: dict, cfg: TextConfig, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Out-projection + residual, then the SwiGLU MLP + residual."""
    B, T = attn.shape[:2]
    a = attn.reshape(B, T, -1)
    x = x + (spmd.row_parallel(a, lp["o_proj"], qm) if lp.get("tp_attn")
             else qm(a, lp["o_proj"]))
    h = rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    if lp.get("tp_mlp"):
        h = spmd.copy_to_model(h)
    a = F.silu(qm(h, lp["gate_proj"])) * qm(h, lp["up_proj"])
    return x + (spmd.row_parallel(a, lp["down_proj"], qm) if lp.get("tp_mlp")
                else qm(a, lp["down_proj"]))


def _dense_layer(layers, l, cfg, x, cos, sin, attn_mask, position_ids, attn_impl, spmd_state):
    """One decoder layer over the T positions alone (no cache); the layer's
    weights are gathered inside, so a checkpointed layer gathers them again
    in the backward instead of keeping them. ``spmd_state``
    (``spmd.capture()``) is re-entered, as the recompute may run on another
    thread."""
    with spmd.restore(spmd_state):
        lp = layer_weights(layers, l, cfg)
        q, k, v = _layer_qkv(lp, cfg, x, cos, sin)
        attn_out = multi_head_attention(
            q, k, v, causal=True, q_positions=position_ids, kv_mask=attn_mask, impl=attn_impl
        )
        return _layer_out(lp, cfg, x, attn_out)


# What ``remat="dots"`` keeps: the outputs of the 2-D products (every
# projection of a layer; ``qmatmul`` folds the token axes into one), as
# ``dots_with_no_batch_dims_saveable`` keeps dots without batch dimensions.
# Attention products carry a batch dimension and are recomputed, as is the
# flash forward, whose kernel is opaque to the policy.
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_PRODUCTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def llama_forward(
    params: dict,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,
    *,
    attn_mask: torch.Tensor,
    position_ids: torch.Tensor,
    cache: Optional[KVCache] = None,
    write_offset: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    remat=False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack (``llama.py:193``).

    inputs_embeds [B, T, D]; attn_mask [B, T] validity of the current
    positions (prefix-contiguous per row); position_ids [B, T] absolute
    positions. With a cache, K/V are written at ``write_offset + arange(T)``
    (default ``cache.length``) into the cache in place and attention spans the
    whole cache; without one, attention is over the T positions.

    ``remat`` (the cache-free path only) checkpoints each layer with
    ``torch.utils.checkpoint`` (non-reentrant): ``True`` saves the layer's
    input and recomputes the layer in the backward; ``"dots"`` also saves
    the outputs of its seven projection products and recomputes the rest;
    ``False`` saves everything. The attention of a checkpointed layer runs
    again in the backward, so a differentiated pass over L layers on the
    flash route launches the forward kernel 2L times (L, then L recomputed)
    and the backward L times; with ``remat=False``, L and L.

    Returns (hidden [B, T, D] after the final norm, the cache or None).
    """
    B, T, D = inputs_embeds.shape
    use_cache = cache is not None
    if remat and use_cache:
        raise ValueError("remat applies to the cache-free path only")
    # A cache holding this rank's rows of the batch: the step runs on them.
    rows = slice(None)
    split = spmd.mesh() is not None and use_cache and cache.k.shape[1] != B
    if split:
        rows = spmd.row_slice(B)
    cos, sin = rope_cos_sin(position_ids[rows], cfg.head_dim, cfg.rope_theta)
    if use_cache:
        if write_offset is None:
            write_offset = cache.length
        write_offset = write_offset.to(torch.int64)
        s_max = cache.k.shape[2]
        n_valid = attn_mask.to(torch.int64).sum(dim=1)
        pos_s = torch.arange(s_max, device=inputs_embeds.device)[None, :]
        new_kv_mask = cache.kv_mask | (
            (pos_s >= write_offset[:, None]) & (pos_s < (write_offset + n_valid)[:, None])
        )
        n_rows = cache.k.shape[1]
        rows_ix = torch.arange(n_rows, device=inputs_embeds.device)[:, None]
        write_pos = (write_offset[rows][:, None]
                     + torch.arange(T, device=inputs_embeds.device)[None, :])
        kv_mask_at = new_kv_mask[rows]

    context_fn = ckpt.noop_context_fn
    if remat == "dots":
        context_fn = functools.partial(ckpt.create_selective_checkpoint_contexts, _dots_policy)
    x = inputs_embeds[rows]
    pos_at = position_ids[rows]
    spmd_state = spmd.capture()
    L = params["layers"]["q_proj"].shape[0]
    for l in range(L):
        if not use_cache:
            args = (params["layers"], l, cfg, x, cos, sin, attn_mask, position_ids, attn_impl,
                    spmd_state)
            if remat:
                x = ckpt.checkpoint(
                    _dense_layer, *args, use_reentrant=False, context_fn=context_fn
                )
            else:
                x = _dense_layer(*args)
            continue
        lp = layer_weights(params["layers"], l, cfg)
        q, k, v = _layer_qkv(lp, cfg, x, cos, sin)
        k_sc = v_sc = None
        if cache.quantized:
            # In-place writes of the int8 values and their scales.
            kq, ks = _kv_quantize(k)
            vq, vs = _kv_quantize(v)
            cache.k[l][rows_ix, write_pos] = kq
            cache.v[l][rows_ix, write_pos] = vq
            cache.k_scale[l][rows_ix, write_pos] = ks
            cache.v_scale[l][rows_ix, write_pos] = vs
            if T <= QUANT_FOLD_T_MAX:
                # Decode / verify windows: the scales fold into the plain
                # route's logits and probabilities.
                k_at, v_at = cache.k[l], cache.v[l]
                k_sc, v_sc = cache.k_scale[l][..., 0], cache.v_scale[l][..., 0]
            else:
                # A prefill: the flash route over the dequantized layer.
                k_at = cache.k[l].to(x.dtype) * cache.k_scale[l].to(x.dtype)
                v_at = cache.v[l].to(x.dtype) * cache.v_scale[l].to(x.dtype)
        else:
            # In-place token writes into this layer's slice of the cache.
            cache.k[l][rows_ix, write_pos] = k.to(cache.k.dtype)
            cache.v[l][rows_ix, write_pos] = v.to(cache.v.dtype)
            k_at, v_at = cache.k[l], cache.v[l]
        with spmd.local_rows() if split else contextlib.nullcontext():
            attn_out = multi_head_attention(
                q, k_at, v_at, causal=True, q_positions=pos_at, kv_mask=kv_mask_at,
                impl=attn_impl, k_scale=k_sc, v_scale=v_sc,
            )
        x = _layer_out(lp, cfg, x, attn_out)

    new_cache = None
    if use_cache:
        new_cache = dataclasses.replace(cache, kv_mask=new_kv_mask, length=write_offset + n_valid)
    out = rms_norm(x, spmd.weight(params["norm"]), cfg.rms_norm_eps)
    return (spmd.gather_rows(out) if split else out), new_cache


# Largest speculative window the engines accept (``llama.py:82``): past it the
# JAX package's int8-KV verify would fall into its dequantize-the-cache prefill
# branch.
QUANT_FOLD_T_MAX = 32


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., HD] -> (int8 values, f32 per-vector scales [..., 1]): absmax/127
    with a 1e-8 floor, round half to even, clip to +-127 (``llama.py:178``)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _paged_rows(B: int, n_pages: int, page_table: torch.Tensor, *tensors):
    """Over a distributed mesh: this rank's rows of ``page_table`` and of
    each of ``tensors``, the table's global page ids rebased once to this
    rank's pools of ``n_pages`` pages (a row shard's pages start at
    ``row_index * n_pages``, ``paged_attention.py:448-470``). Returns (mesh
    or None, the table the kernels read, the table the writers read -- its
    ids clipped into the local pool, as JAX's writers clip them --, the
    tensors)."""
    m = spmd.mesh()
    if m is None:
        return None, page_table, page_table, list(tensors)
    rows = spmd.row_slice(B)
    table = page_table[rows] - m.row_index * n_pages
    return m, table, table.clamp(0, n_pages - 1), [t[rows] for t in tensors]


def llama_paged_decode(
    params: dict,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # [B, 1, D]
    positions: torch.Tensor,  # [B] absolute position of the new token
    k_pages: torch.Tensor,  # [L, n_pages, KH, page, HD] (int8 if quantized)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, P_max] int32
    lengths: torch.Tensor,  # [B] tokens BEFORE this step
    active: torch.Tensor,  # [B] bool
    *,
    k_scale: Optional[torch.Tensor] = None,  # [L, n_pages, KH, page] f32
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode step over paged KV (``llama.py:392``): each
    layer writes the step's K/V (int8 + scales when ``k_scale`` is given)
    into the row's current page and attends over ``lengths + active``
    tokens -- in one fused kernel with ``FUSED_APPEND``, else the writers
    then the paged kernel. The pools are updated IN PLACE; returns hidden
    [B, 1, D] after the final norm. Over a distributed mesh the pools are
    this rank's rows and heads and the table holds global page ids (module
    note)."""
    from vcoder_tpu_torch.ops import paged_attention as pa

    B, T, _ = inputs_embeds.shape
    if T != 1:
        raise ValueError(f"decode takes one token per row, got {T}")
    m, page_table, write_table, (inputs_embeds, positions, lengths, active) = _paged_rows(
        B, k_pages.shape[1], page_table, inputs_embeds, positions, lengths, active)
    page = k_pages.shape[3]
    quantized = k_scale is not None
    fused = pa.FUSED_APPEND
    cos, sin = rope_cos_sin(positions[:, None], cfg.head_dim, cfg.rope_theta)
    pos = positions.long()
    ids, valid = pa.lookup_pages(write_table, (pos // page)[:, None])
    row_pages = torch.where(valid, ids, 0)[:, 0]  # past the table: page 0, as JAX
    offsets = pos % page
    attn_lengths = lengths + active.to(lengths.dtype)
    x = inputs_embeds
    L = params["layers"]["q_proj"].shape[0]
    for l in range(L):
        lp = layer_weights(params["layers"], l, cfg)
        q, k, v = _layer_qkv(lp, cfg, x, cos, sin)
        if fused:
            # The token's K/V enter the kernel as operands: attended from
            # there and written to its slot in the same launch.
            kw = dict(window=1)
            if quantized:
                k, ks = _kv_quantize(k)  # [B, 1, KH, HD], [B, 1, KH, 1]
                v, vs = _kv_quantize(v)
                kw.update(k_scale=k_scale, v_scale=v_scale, new_ks=ks[..., 0],
                          new_vs=vs[..., 0])
            attn = pa.carry_paged_attention_fused(
                q, k.to(k_pages.dtype), v.to(v_pages.dtype), k_pages, v_pages, page_table,
                attn_lengths, positions, active, l, **kw,
            )[:, 0]
        elif quantized:
            kq, ks = _kv_quantize(k[:, 0])
            vq, vs = _kv_quantize(v[:, 0])
            pa.append_token_layer(k_pages, l, kq, row_pages, offsets, active)
            pa.append_token_layer(v_pages, l, vq, row_pages, offsets, active)
            pa.append_scale_layer(k_scale, l, ks, row_pages, offsets, active)
            pa.append_scale_layer(v_scale, l, vs, row_pages, offsets, active)
            attn = pa.carry_paged_attention_q8(
                q[:, 0], k_pages, v_pages, k_scale, v_scale, page_table, attn_lengths, l
            )
        else:
            pa.append_token_layer(k_pages, l, k[:, 0], row_pages, offsets, active)
            pa.append_token_layer(v_pages, l, v[:, 0], row_pages, offsets, active)
            attn = pa.carry_paged_attention(
                q[:, 0], k_pages, v_pages, page_table, attn_lengths, l
            )
        x = _layer_out(lp, cfg, x, attn[:, None])
    out = rms_norm(x, spmd.weight(params["norm"]), cfg.rms_norm_eps)
    return out if m is None else spmd.gather_rows(out)


def llama_paged_verify(
    params: dict,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # [B, k, D] window (current token + drafts, or a chunk)
    positions: torch.Tensor,  # [B, k] absolute positions of the window
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, P_max] int32
    lengths: torch.Tensor,  # [B] tokens BEFORE this window
    active: torch.Tensor,  # [B] bool
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    page_aligned: bool = False,
) -> torch.Tensor:
    """Window forward over paged KV (``llama.py:576``, single device): write
    the window's k tokens (a window may straddle a page boundary) and attend
    each causally up to its own position. With ``FUSED_APPEND`` a window of
    at most 16 tokens (speculative verify) appends and attends in one fused
    kernel per layer (``:628``); chunk windows keep the writers and the paged
    kernel. The window must be position-contiguous per row (the fused kernel
    writes ``positions[:, 0] + t``), which both callers guarantee.
    ``page_aligned`` is the caller's guarantee that ``positions[:, 0] % page
    == 0``; with ``k % page == 0`` the write is page-granular
    (``:635-636``). Pools are updated IN PLACE; returns hidden [B, k, D]
    after the final norm."""
    from vcoder_tpu_torch.ops import paged_attention as pa

    B, k, _ = inputs_embeds.shape
    m, page_table, write_table, (inputs_embeds, positions, lengths, active) = _paged_rows(
        B, k_pages.shape[1], page_table, inputs_embeds, positions, lengths, active)
    quantized = k_scale is not None
    use_fused = pa.FUSED_APPEND and k <= 16
    use_pages = page_aligned and not use_fused and k % k_pages.shape[3] == 0
    append = pa.append_pages_layer if use_pages else pa.append_tokens_layer
    append_s = pa.append_page_scales_layer if use_pages else pa.append_token_scales_layer
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    attn_lengths = lengths + k * active.to(lengths.dtype)
    x = inputs_embeds
    L = params["layers"]["q_proj"].shape[0]
    for l in range(L):
        lp = layer_weights(params["layers"], l, cfg)
        q, kk, v = _layer_qkv(lp, cfg, x, cos, sin)
        if use_fused:
            kw = dict(window=k)
            if quantized:
                kk, ks = _kv_quantize(kk)
                v, vs = _kv_quantize(v)
                kw.update(k_scale=k_scale, v_scale=v_scale, new_ks=ks[..., 0],
                          new_vs=vs[..., 0])
            attn = pa.carry_paged_attention_fused(
                q, kk.to(k_pages.dtype), v.to(v_pages.dtype), k_pages, v_pages, page_table,
                attn_lengths, positions[:, 0], active, l, **kw,
            )
        elif quantized:
            kq, ks = _kv_quantize(kk)
            vq, vs = _kv_quantize(v)
            append(k_pages, l, kq, positions, write_table, active)
            append(v_pages, l, vq, positions, write_table, active)
            append_s(k_scale, l, ks, positions, write_table, active)
            append_s(v_scale, l, vs, positions, write_table, active)
            attn = pa.carry_paged_attention_multi_q8(
                q, k_pages, v_pages, k_scale, v_scale, page_table, attn_lengths, l,
                window=k,
            )
        else:
            append(k_pages, l, kk, positions, write_table, active)
            append(v_pages, l, v, positions, write_table, active)
            attn = pa.carry_paged_attention_multi(
                q, k_pages, v_pages, page_table, attn_lengths, l, window=k
            )
        x = _layer_out(lp, cfg, x, attn)
    out = rms_norm(x, spmd.weight(params["norm"]), cfg.rms_norm_eps)
    return out if m is None else spmd.gather_rows(out)


def lm_head(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """[B, T, D] -> [B, T, V] logits in f32 (the vocabulary split over
    ``model`` on a mesh, the logits gathered)."""
    return spmd.column_product(hidden, params["lm_head"], qm).float()


def embed_tokens(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return spmd.embed(params["embed_tokens"], ids)
