"""Flash attention, forward and backward: the CUDA kernels
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` and their plain PyTorch
versions, joined in one ``torch.autograd.Function``.

Port of ``vcoder_tpu/ops/flash_attention.py``: the public
``flash_attention:733`` over the custom_vjp ``_flash_core:693-719``, the
forward ``_flash_fwd:262`` (kernels ``_fwd_kernel:204`` /
``_fwd_kernel_tri:216``) and the backward ``_flash_bwd:570`` (kernels
``_bwd_dq_kernel:446`` / ``_bwd_dkv_kernel:503`` over ``_recompute_p:412``).
Semantics are those of ``ops.attention.xla_attention``: q ``[B,T,H,D]``,
k/v ``[B,S,KH,D]`` with ``H % KH == 0``; causality by position (key j is
visible to query t when ``j <= q_positions[b, t]``); ``kv_mask[b, j]`` hides
pad and unwritten slots; a row with no visible key gives 0 (and gradients 0).
As in ``_flash_fwd:272`` and ``_recompute_p``, q is scaled by ``D**-0.5`` in
f32 and rounded to its dtype before the QK product, in both directions.

The wrappers take the plain version for a tensor on the CPU and launch the
kernel for a tensor on CUDA; there is no fallback from one to the other.
``launches`` counts forward launches made by :func:`flash_fwd`,
``bwd_launches`` backward calls made by :func:`flash_bwd` (each launches the
dq kernel and then the dkv kernel). :class:`FlashAttention` is the
differentiable op: :func:`flash_attention` goes through it, so the CPU tests
exercise the Function that the card runs.
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
bwd_launches = 0


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


def _operand_ok(x: torch.Tensor) -> bool:
    """The kernels read a head's row as 16-byte vectors: the head dim is
    contiguous, the other strides are multiples of 8 elements and the data
    is 16-byte aligned."""
    return (
        x.stride(-1) == 1
        and not any(s % 8 for s in x.stride()[:-1])
        and x.data_ptr() % 16 == 0
    )


def _check_operand(name: str, x: torch.Tensor, what: str = "flash_fwd") -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what}: {name} must be bfloat16, got {x.dtype}")
    if not _operand_ok(x):
        raise ValueError(
            f"{what}: {name} must be contiguous in head_dim, its other strides "
            "multiples of 8 elements and its data 16-byte aligned"
        )


def _kernel_masks(B, T, S, q_positions, kv_mask, causal, device):
    """int32 [B, T] positions (causal only) and [B, S] key mask (or None),
    contiguous on ``device``, as the kernels read them."""
    if causal:
        if q_positions is None:
            q_positions = _default_positions(B, T, S, device)
        q_positions = q_positions.to(device=device, dtype=torch.int32).contiguous()
        if q_positions.shape != (B, T):
            raise ValueError("flash attention: q_positions must be [B, T]")
    else:
        q_positions = None
    if kv_mask is not None:
        kv_mask = kv_mask.to(device=device, dtype=torch.int32).contiguous()
        if kv_mask.shape != (B, S):
            raise ValueError("flash attention: kv_mask must be [B, S]")
    return q_positions, kv_mask


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
    q_positions, kv_mask = _kernel_masks(B, T, S, q_positions, kv_mask, causal, q.device)
    qpos_ptr = None if q_positions is None else q_positions.data_ptr()
    mask_ptr = None if kv_mask is None else kv_mask.data_ptr()
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
    _kernels.forbid_grad("flash_fwd", q, k, v)
    out = launch_flash_fwd(
        q, k, v, q_positions, kv_mask, causal=causal, scale=scale
    )
    launches += 1
    return out


def flash_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    q_positions: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    *,
    causal: bool,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: (dq [B,T,H,D], dk, dv
    [B,S,KH,D]) in the inputs' dtypes.

    f32 arithmetic with the kernels' roundings (``_flash_bwd``): P recomputed
    from the saved lse against q scaled in f32 and rounded to its dtype, zero
    on hidden keys; ``delta = rowsum(dO * O)`` in f32; dS rounded to the
    operands' dtype before ``dS K`` and ``dS^T q``, P rounded before
    ``P^T dO``; dK/dV summed over each KV head's query group."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    if scale is None:
        scale = D**-0.5
    qs = (q.float() * scale).to(q.dtype)
    kr = repeat_kv(k, G).float()
    vr = repeat_kv(v, G).float()
    s = torch.einsum("bthd,bshd->bhts", qs.float(), kr)
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
    mask = mask[:, None]
    p = torch.exp(torch.where(mask, s, torch.full_like(s, NEG_INF)) - lse.float()[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    do32 = dout.float()
    dp = torch.einsum("bthd,bshd->bhts", do32, vr)
    delta = (do32 * out.float()).sum(-1).permute(0, 2, 1)  # [B,H,T]
    ds = p * (dp - delta[..., None])
    dq = scale * torch.einsum("bhts,bshd->bthd", ds.to(k.dtype).float(), kr)
    dv = torch.einsum("bhts,bthd->bshd", p.to(dout.dtype).float(), do32)
    dk = scale * torch.einsum("bhts,bthd->bshd", ds.to(q.dtype).float(), q.float())

    def group_sum(x):  # [B,S,H,D] -> [B,S,KH,D]
        return x.reshape(B, S, KH, G, D).sum(dim=3)

    return dq.to(q.dtype), group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)


def launch_flash_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    q_positions: Optional[torch.Tensor],
    kv_mask: Optional[torch.Tensor],
    *,
    causal: bool,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on CUDA tensors (no counting; see
    :func:`flash_bwd`). q/k/v/out/dout may be strided views (head dim
    contiguous); a dout or out the kernels cannot read (the gradient of a
    reshape may arrive with any strides) is made contiguous first. The dq
    kernel computes ``delta = rowsum(dO * O)`` itself and writes it, with q
    scaled and rounded, to scratch the dkv kernel reads."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    if D != 128:
        raise ValueError(f"flash_bwd: head_dim {D} != 128")
    if H % KH or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_bwd: bad shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    if dout.shape != q.shape or out.shape != q.shape or lse.shape != (B, H, T):
        raise ValueError("flash_bwd: dout/out must be [B,T,H,D] and lse [B,H,T]")
    if dout.dtype == torch.bfloat16 and not _operand_ok(dout):
        dout = dout.contiguous()
    if out.dtype == torch.bfloat16 and not _operand_ok(out):
        out = out.contiguous()
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        if x.device != q.device:
            raise ValueError(f"flash_bwd: {name} is on {x.device}, q on {q.device}")
        _check_operand(name, x, "flash_bwd")
    q_positions, kv_mask = _kernel_masks(B, T, S, q_positions, kv_mask, causal, q.device)
    lse = lse.to(device=q.device, dtype=torch.float32).contiguous()
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    qs = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, KH, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, S, KH, D), dtype=v.dtype, device=q.device)
    fn = _kernels.lib("flash_bwd").flash_bwd
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), qs.data_ptr(),
        None if q_positions is None else q_positions.data_ptr(),
        None if kv_mask is None else kv_mask.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, T, S, H, KH, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        dout.stride(0), dout.stride(1), dout.stride(2),
        float(scale), int(causal), _kernels.stream_handle(q.device),
    )
    _kernels.check(err, "flash_bwd")
    return dq, dk, dv


def flash_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    q_positions: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    *,
    causal: bool,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the attention whose forward gave (out, lse), for the
    output gradient ``dout``: the kernels on CUDA, the plain version on the
    CPU."""
    global bwd_launches
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_bwd_ref(
            q, k, v, out, lse, dout, q_positions, kv_mask, causal=causal, scale=scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd: unsupported device {q.device}")
    _kernels.forbid_grad("flash_bwd", q, k, v, out, dout)
    grads = launch_flash_bwd(
        q, k, v, out, lse, dout, q_positions, kv_mask, causal=causal, scale=scale
    )
    bwd_launches += 1
    return grads


class FlashAttention(torch.autograd.Function):
    """The flash forward with the flash backward as its gradient: the
    counterpart of the custom_vjp ``_flash_core`` (``:693-719``). The
    forward saves q, k, v, the output, the lse, the positions and the mask;
    the backward returns (dq, dk, dv) and no gradient for the positions,
    the mask or ``causal``."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_mask, causal):
        out, lse = flash_fwd(q, k, v, q_positions, kv_mask, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse, q_positions, kv_mask)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_positions, kv_mask = ctx.saved_tensors
        dq, dk, dv = flash_bwd(
            q, k, v, out, lse, dout, q_positions, kv_mask, causal=ctx.causal
        )
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_positions: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention ([B,T,H,D] out), differentiable in q, k and v;
    counterpart of the JAX ``flash_attention``. The kernel's loop bound gives
    the causal skip for any positions, so there is no ``bounded_positions``
    switch."""
    return FlashAttention.apply(q, k, v, q_positions, kv_mask, causal)
