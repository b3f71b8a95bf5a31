"""Attention entry points (port of ``vcoder_tpu/ops/attention.py``).

:func:`multi_head_attention` dispatches between

* ``xla``  -- :func:`xla_attention`, plain PyTorch (the counterpart of the
              JAX package's jnp path; decode steps and short windows);
* ``auto`` -- the flash-attention forward (``ops/flash_attention.py``) for
              long attention: the CUDA kernel for CUDA tensors, its plain
              version for CPU ones.

Layout throughout: ``[batch, seq, heads, head_dim]``. Grouped-query
attention passes fewer KV heads.

Over a distributed mesh (``parallel/spmd.py``) the flash route is JAX's
``sharded_flash_attention`` (``attention.py:180-231``): batch over ``data x
fsdp``, heads over ``model``, one flash call per rank on its rows and
heads, which the model code holds already as local tensors; a batch the
row shards do not divide takes the plain route, as JAX's ``:156-168``
does.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-but-finite; avoids NaNs from (-inf) - (-inf)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KH, D] -> [B, S, KH*n_rep, D] by head repetition (GQA)."""
    if n_rep == 1:
        return x
    b, s, kh, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kh, n_rep, d).reshape(b, s, kh * n_rep, d)


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_positions: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference attention in plain PyTorch (``attention.py:39-115``).

    q: [B, T, H, D]; k, v: [B, S, KH, D]; q_positions: [B, T] absolute query
    positions (default: the last query aligned with the last key); kv_mask:
    [B, S] validity of each key slot. Logits are f32; masked logits take the
    finite NEG_INF, so a fully-masked row averages v uniformly, as in JAX.
    ``k_scale``/``v_scale`` [B, S, KH] dequantize int8 k/v inside the math:
    the logits are multiplied by k's scale after the dot, the probabilities
    by v's before the PV product, so no dequantized copy is made.
    """
    b, t, h, d = q.shape
    s = k.shape[1]
    kh = k.shape[2]
    if scale is None:
        scale = d**-0.5

    def per_head(x):  # [B, S, KH] -> [B, H, 1, S]
        return x.float().repeat_interleave(h // kh, dim=2).permute(0, 2, 1)[:, :, None, :]

    k = repeat_kv(k.to(q.dtype), h // kh)
    v = repeat_kv(v.to(q.dtype), h // kh)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if k_scale is not None:
        logits = logits * per_head(k_scale)
    mask = torch.ones((b, t, s), dtype=torch.bool, device=q.device)
    if causal:
        if q_positions is None:
            q_pos = (torch.arange(t, device=q.device) + (s - t))[None, :].expand(b, t)
        else:
            q_pos = q_positions
        k_pos = torch.arange(s, device=q.device)[None, :]
        mask = mask & (k_pos[:, None, :] <= q_pos[:, :, None])
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, :].bool()
    logits = torch.where(mask[:, None], logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * per_head(v_scale)
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_positions: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    impl: str = "auto",
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dispatching attention; see :func:`xla_attention` for semantics.

    The routing of ``attention.py:131-151``: scales (an int8 cache) force the
    plain route; ``auto`` takes the flash route, except decode steps and
    short windows (T <= 16) and bidirectional attention with head_dim < 128,
    which take the plain route; ``impl="xla"`` names the plain route
    outright."""
    if k_scale is not None or v_scale is not None:
        return xla_attention(
            q, k, v, causal=causal, q_positions=q_positions, kv_mask=kv_mask,
            k_scale=k_scale, v_scale=v_scale,
        )
    if impl == "auto" and (q.shape[1] <= 16 or (not causal and q.shape[-1] < 128)):
        impl = "xla"
    if impl == "auto":
        from vcoder_tpu_torch.ops.flash_attention import flash_attention
        from vcoder_tpu_torch.parallel import spmd

        m = spmd.mesh()
        if m is not None and spmd.global_rows(q.shape[0]) % m.row_shards:
            # JAX's sharded_flash_attention returns None: the plain route.
            return xla_attention(
                q, k, v, causal=causal, q_positions=q_positions, kv_mask=kv_mask
            )
        return flash_attention(
            q, k, v, causal=causal, q_positions=q_positions, kv_mask=kv_mask
        )
    if impl == "xla":
        return xla_attention(
            q, k, v, causal=causal, q_positions=q_positions, kv_mask=kv_mask
        )
    raise ValueError(f"Unknown attention impl: {impl}")
