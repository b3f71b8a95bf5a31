"""Flash-attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its
plain PyTorch version.

Port of ``vcoder_tpu/ops/flash_attention.py`` (forward only: the public
``flash_attention:733`` over ``_flash_fwd:262`` and its kernels
``_fwd_kernel:204`` / ``_fwd_kernel_tri:216``). Semantics are those of
``ops.attention.xla_attention``: q ``[B,T,H,D]``, k/v ``[B,S,KH,D]`` with
``H % KH == 0``; causality by position (key j is visible to query t when
``j <= q_positions[b, t]``); ``kv_mask[b, j]`` hides pad and unwritten slots;
a row with no visible key gives 0. As in ``_flash_fwd:272``, q is scaled by
``D**-0.5`` in f32 and rounded to its dtype before the QK product.

The wrapper takes the plain version for a tensor on the CPU and launches the
kernel for a tensor on CUDA; there is no fallback from one to the other.
``launches`` counts kernel launches made by :func:`flash_fwd`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vcoder_tpu_torch.ops import _kernels
from vcoder_tpu_torch.ops.attention import NEG_INF, repeat_kv

# Finite floor of the running row max (flash_attention.py:92-95): a row with
# no visible key keeps exp() finite and sums to l == 0, which gives 0.
M_FLOOR = -1e20

launches = 0


def _default_positions(B: int, T: int, S: int, device) -> torch.Tensor:
    return (torch.arange(T, device=device, dtype=torch.int32) + (S - T))[
        None, :
    ].expand(B, T)


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    *,
    causal: bool,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (out [B,T,H,D], lse [B,H,T] f32).

    One-pass softmax with the kernel's arithmetic: scaled q rounded to its
    dtype, f32 logits, finite NEG_INF masking with the M_FLOOR row floor,
    unnormalized p rounded to v's dtype for the PV product, then division by
    the row sum (1 where the sum is 0)."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    if scale is None:
        scale = D**-0.5
    qs = (q.float() * scale).to(q.dtype)
    kr = repeat_kv(k, H // KH)
    vr = repeat_kv(v, H // KH)
    s = torch.einsum("bthd,bshd->bhts", qs.float(), kr.float())
    mask = torch.ones((B, T, S), dtype=torch.bool, device=q.device)
    if causal:
        pos = (
            _default_positions(B, T, S, q.device)
            if q_positions is None
            else q_positions
        )
        k_pos = torch.arange(S, device=q.device)
        mask = mask & (k_pos[None, None, :] <= pos[:, :, None])
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, :].bool()
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(M_FLOOR)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # [B,H,T,1]
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), vr.float())
    out = (o / l_safe.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(l_safe))[..., 0]
    return out, lse


def _check_operand(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash_fwd: {name} must be bfloat16, got {x.dtype}")
    if x.stride(-1) != 1:
        raise ValueError(f"flash_fwd: {name} must be contiguous in head_dim")
    if any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
        raise ValueError(
            f"flash_fwd: {name} strides must be multiples of 8 elements and "
            "its data 16-byte aligned"
        )


def launch_flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: Optional[torch.Tensor],
    kv_mask: Optional[torch.Tensor],
    *,
    causal: bool,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on CUDA tensors (no counting; see
    :func:`flash_fwd`). q/k/v may be strided views (head dim contiguous)."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    if D not in (64, 128):
        raise ValueError(f"flash_fwd: head_dim {D} not in (64, 128)")
    if H % KH or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_fwd: bad shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_fwd: {name} is on {x.device}, q on {q.device}")
        _check_operand(name, x)
    qpos_ptr = None
    if causal:
        if q_positions is None:
            q_positions = _default_positions(B, T, S, q.device)
        q_positions = q_positions.to(device=q.device, dtype=torch.int32).contiguous()
        if q_positions.shape != (B, T):
            raise ValueError("flash_fwd: q_positions must be [B, T]")
        qpos_ptr = q_positions.data_ptr()
    mask_ptr = None
    if kv_mask is not None:
        kv_mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
        if kv_mask.shape != (B, S):
            raise ValueError("flash_fwd: kv_mask must be [B, S]")
        mask_ptr = kv_mask.data_ptr()
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    fn = _kernels.lib("flash_fwd").flash_fwd
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos_ptr, mask_ptr,
        out.data_ptr(), lse.data_ptr(),
        B, T, S, H, KH, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), int(causal), _kernels.stream_handle(q.device),
    )
    _kernels.check(err, "flash_fwd")
    return out, lse


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    *,
    causal: bool,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,T,H,D], lse [B,H,T]): the kernel on CUDA, the plain version
    on the CPU."""
    global launches
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(
            q, k, v, q_positions, kv_mask, causal=causal, scale=scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    out = launch_flash_fwd(
        q, k, v, q_positions, kv_mask, causal=causal, scale=scale
    )
    launches += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_positions: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention ([B,T,H,D] out); counterpart of the JAX
    ``flash_attention``. The kernel's loop bound gives the causal skip for
    any positions, so there is no ``bounded_positions`` switch."""
    out, _ = flash_fwd(
        q, k, v, q_positions, kv_mask, causal=causal
    )
    return out
