"""Llama (Vicuna v1.5) decoder (port of ``vcoder_tpu/models/llama.py``).

* Parameters keep the JAX package's layer-stacked dict: matrices
  ``[L, in, out]`` (``x @ W``), norms ``[L, D]``; a Python loop over layers
  replaces ``lax.scan``.
* RMSNorm normalizes in f32, casts to the input dtype, then multiplies by the
  weight (``llama.py:85-91``); RoPE is rotate-half over f32 positions
  (``:94-114``).
* The dense :class:`KVCache` (``:122-168``, unquantized form) is updated IN
  PLACE: each layer's new K/V rows are written into the preallocated
  ``[L, B, S, KH, HD]`` tensors (JAX's functional carry is no model for
  PyTorch). Writes land at ``write_offset + arange(T)`` per row
  (``:249-258``); ``kv_mask`` marks only ``[offset, offset + n_valid)``
  (``:234-239``); pad rows write garbage that ``kv_mask`` never marks and a
  later write at the same slot overwrites.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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
    length: [B] populated slots per row.
    """

    k: torch.Tensor
    v: torch.Tensor
    kv_mask: torch.Tensor
    length: torch.Tensor

    @staticmethod
    def create(
        cfg: TextConfig, batch: int, max_len: int, *, dtype=torch.float32, device="cpu"
    ) -> "KVCache":
        L, KH, HD = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        return KVCache(
            k=torch.zeros((L, batch, max_len, KH, HD), dtype=dtype, device=device),
            v=torch.zeros((L, batch, max_len, KH, HD), dtype=dtype, device=device),
            kv_mask=torch.zeros((batch, max_len), dtype=torch.bool, device=device),
            length=torch.zeros((batch,), dtype=torch.int64, device=device),
        )


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
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack (``llama.py:193``).

    inputs_embeds [B, T, D]; attn_mask [B, T] validity of the current
    positions (prefix-contiguous per row); position_ids [B, T] absolute
    positions. With a cache, K/V are written at ``write_offset + arange(T)``
    (default ``cache.length``) into the cache in place and attention spans the
    whole cache; without one, attention is over the T positions.

    Returns (hidden [B, T, D] after the final norm, the cache or None).
    """
    B, T, D = inputs_embeds.shape
    H, KH, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    cos, sin = rope_cos_sin(position_ids, HD, cfg.rope_theta)

    use_cache = cache is not None
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

    x = inputs_embeds
    L = params["layers"]["q_proj"].shape[0]
    for l in range(L):
        lp = {k: v[l] for k, v in params["layers"].items()}
        residual = x
        h = rms_norm(x, lp["input_layernorm"], eps)
        q = qm(h, lp["q_proj"]).reshape(B, T, H, HD)
        k = qm(h, lp["k_proj"]).reshape(B, T, KH, HD)
        v = qm(h, lp["v_proj"]).reshape(B, T, KH, HD)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if use_cache:
            # In-place token writes into this layer's slice of the cache.
            cache.k[l][rows_ix, write_pos] = k.to(cache.k.dtype)
            cache.v[l][rows_ix, write_pos] = v.to(cache.v.dtype)
            attn_out = multi_head_attention(
                q, cache.k[l], cache.v[l], causal=True,
                q_positions=position_ids, kv_mask=new_kv_mask, impl=attn_impl,
            )
        else:
            attn_out = multi_head_attention(
                q, k, v, causal=True,
                q_positions=position_ids, kv_mask=attn_mask, impl=attn_impl,
            )
        x = residual + qm(attn_out.reshape(B, T, H * HD), lp["o_proj"])
        h = rms_norm(x, lp["post_attention_layernorm"], eps)
        x = x + qm(F.silu(qm(h, lp["gate_proj"])) * qm(h, lp["up_proj"]), lp["down_proj"])

    new_cache = None
    if use_cache:
        new_cache = KVCache(
            k=cache.k, v=cache.v, kv_mask=new_kv_mask, length=write_offset + n_valid
        )
    return rms_norm(x, params["norm"], eps), new_cache


def lm_head(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """[B, T, D] -> [B, T, V] logits in f32."""
    return qm(hidden, params["lm_head"]).float()


def embed_tokens(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][ids]
