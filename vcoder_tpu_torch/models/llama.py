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
  written in place. With ``ops.paged_attention.FUSED_APPEND`` (read at call
  time) a decode step and a verify window of at most 16 tokens append and
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

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from vcoder_tpu_torch.config import TextConfig
from vcoder_tpu_torch.ops.attention import multi_head_attention
from vcoder_tpu_torch.ops.quant import qmatmul as qm


def init_llama_params(
    generator: torch.Generator, cfg: TextConfig, *, dtype=torch.float32, device="cpu"
) -> dict:
    """Random-normal (0.02) init, layer-stacked, sampled directly in ``dtype``
    on ``device`` (no f32 intermediate at 7B)."""
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, KH, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    V = cfg.vocab_size

    def nrm(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(0.02)

    return {
        "embed_tokens": nrm(V, D),
        "layers": {
            "input_layernorm": torch.ones((L, D), dtype=dtype, device=device),
            "post_attention_layernorm": torch.ones((L, D), dtype=dtype, device=device),
            "q_proj": nrm(L, D, H * HD),
            "k_proj": nrm(L, D, KH * HD),
            "v_proj": nrm(L, D, KH * HD),
            "o_proj": nrm(L, H * HD, D),
            "gate_proj": nrm(L, D, I),
            "up_proj": nrm(L, D, I),
            "down_proj": nrm(L, I, D),
        },
        "norm": torch.ones((D,), dtype=dtype, device=device),
        "lm_head": nrm(D, V),
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
    1]; values dequantize at the attention read.
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
        quantized: bool = False,
    ) -> "KVCache":
        L, KH, HD = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        kv_dtype = torch.int8 if quantized else dtype

        def zeros(last, dt):
            return torch.zeros((L, batch, max_len, KH, last), dtype=dt, device=device)

        return KVCache(
            k=zeros(HD, kv_dtype),
            v=zeros(HD, kv_dtype),
            kv_mask=torch.zeros((batch, max_len), dtype=torch.bool, device=device),
            length=torch.zeros((batch,), dtype=torch.int64, device=device),
            k_scale=zeros(1, torch.float32) if quantized else None,
            v_scale=zeros(1, torch.float32) if quantized else None,
        )


def _layer_qkv(lp: dict, cfg: TextConfig, x: torch.Tensor, cos, sin):
    """RMSNorm, q/k/v projections and RoPE of one layer: (q, k, v) as
    [B, T, H|KH, HD]."""
    B, T, _ = x.shape
    H, KH, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["input_layernorm"], cfg.rms_norm_eps)
    q = apply_rope(qm(h, lp["q_proj"]).reshape(B, T, H, HD), cos, sin)
    k = apply_rope(qm(h, lp["k_proj"]).reshape(B, T, KH, HD), cos, sin)
    v = qm(h, lp["v_proj"]).reshape(B, T, KH, HD)
    return q, k, v


def _layer_out(lp: dict, cfg: TextConfig, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Out-projection + residual, then the SwiGLU MLP + residual."""
    B, T = attn.shape[:2]
    x = x + qm(attn.reshape(B, T, -1), lp["o_proj"])
    h = rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    return x + qm(F.silu(qm(h, lp["gate_proj"])) * qm(h, lp["up_proj"]), lp["down_proj"])


def _dense_layer(lp, cfg, x, cos, sin, attn_mask, position_ids, attn_impl):
    """One decoder layer over the T positions alone (no cache)."""
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
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)

    use_cache = cache is not None
    if remat and use_cache:
        raise ValueError("remat applies to the cache-free path only")
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
        rows_ix = torch.arange(B, device=inputs_embeds.device)[:, None]
        write_pos = write_offset[:, None] + torch.arange(T, device=inputs_embeds.device)[None, :]

    context_fn = ckpt.noop_context_fn
    if remat == "dots":
        context_fn = functools.partial(ckpt.create_selective_checkpoint_contexts, _dots_policy)
    x = inputs_embeds
    L = params["layers"]["q_proj"].shape[0]
    for l in range(L):
        lp = {k: v[l] for k, v in params["layers"].items()}
        if not use_cache:
            args = (lp, cfg, x, cos, sin, attn_mask, position_ids, attn_impl)
            if remat:
                x = ckpt.checkpoint(
                    _dense_layer, *args, use_reentrant=False, context_fn=context_fn
                )
            else:
                x = _dense_layer(*args)
            continue
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
        attn_out = multi_head_attention(
            q, k_at, v_at, causal=True, q_positions=position_ids, kv_mask=new_kv_mask,
            impl=attn_impl, k_scale=k_sc, v_scale=v_sc,
        )
        x = _layer_out(lp, cfg, x, attn_out)

    new_cache = None
    if use_cache:
        new_cache = dataclasses.replace(cache, kv_mask=new_kv_mask, length=write_offset + n_valid)
    return rms_norm(x, params["norm"], cfg.rms_norm_eps), new_cache


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
    """One decode step over paged KV (``llama.py:392``, single device): each
    layer writes the step's K/V (int8 + scales when ``k_scale`` is given)
    into the row's current page and attends over ``lengths + active``
    tokens -- in one fused kernel with ``FUSED_APPEND``, else the writers
    then the paged kernel. The pools are updated IN PLACE; returns hidden
    [B, 1, D] after the final norm."""
    from vcoder_tpu_torch.ops import paged_attention as pa

    B, T, _ = inputs_embeds.shape
    if T != 1:
        raise ValueError(f"decode takes one token per row, got {T}")
    page = k_pages.shape[3]
    quantized = k_scale is not None
    fused = pa.FUSED_APPEND
    cos, sin = rope_cos_sin(positions[:, None], cfg.head_dim, cfg.rope_theta)
    pos = positions.long()
    ids, valid = pa.lookup_pages(page_table, (pos // page)[:, None])
    row_pages = torch.where(valid, ids, 0)[:, 0]  # past the table: page 0, as JAX
    offsets = pos % page
    attn_lengths = lengths + active.to(lengths.dtype)
    x = inputs_embeds
    L = params["layers"]["q_proj"].shape[0]
    for l in range(L):
        lp = {k: v[l] for k, v in params["layers"].items()}
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
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)


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
        lp = {name: t[l] for name, t in params["layers"].items()}
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
            append(k_pages, l, kq, positions, page_table, active)
            append(v_pages, l, vq, positions, page_table, active)
            append_s(k_scale, l, ks, positions, page_table, active)
            append_s(v_scale, l, vs, positions, page_table, active)
            attn = pa.carry_paged_attention_multi_q8(
                q, k_pages, v_pages, k_scale, v_scale, page_table, attn_lengths, l,
                window=k,
            )
        else:
            append(k_pages, l, kk, positions, page_table, active)
            append(v_pages, l, v, positions, page_table, active)
            attn = pa.carry_paged_attention_multi(
                q, k_pages, v_pages, page_table, attn_lengths, l, window=k
            )
        x = _layer_out(lp, cfg, x, attn)
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)


def lm_head(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """[B, T, D] -> [B, T, V] logits in f32."""
    return qm(hidden, params["lm_head"]).float()


def embed_tokens(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][ids]
