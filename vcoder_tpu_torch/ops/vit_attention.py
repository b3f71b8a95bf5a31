"""The CLIP attention block: CUDA kernels and their plain PyTorch version.

Port of ``vcoder_tpu/ops/vit_attention.py`` (``fused_block_attention:102``
over the TPU kernel ``_block_kernel:52``). One call computes
``MHA(x_ln) @ Wo`` for one CLIP transformer block: the QKV projection with
its bias, the softmax scale folded into Wq and its bias, bidirectional
attention, and the out-projection with f32 accumulation. The caller adds the
out bias and the residual, as on the TPU.

On CUDA the block is three launches of two hand-written kernels: the bf16
GEMM-with-bias of ``csrc/gemm_bias.cu`` for QKV (into a ``[B, T, 3, H, dh]``
layout the attention reads in place), the head-dim-64 flash forward of
``csrc/flash_fwd.cu`` (not causal, scale already folded), and the GEMM again
for the out-projection over all ``H * dh`` inputs. The TPU kernel's 584-row
padding was a sublane rule; here T stays 577 and the kernels mask the ragged
edge. ``launches`` counts block calls that launched the kernels.

Weight layout (:func:`repack_block`): ``wqkv_t [3*Dm, Dm]`` (rows: q|k|v
outputs, head-major inside each), ``bqkv [3*Dm]`` f32, ``wo_t [Dm, Dm]`` --
both matrices output-major, so the GEMM reads them K-contiguous.
"""

from __future__ import annotations

import torch

from vcoder_tpu_torch.ops import _kernels
from vcoder_tpu_torch.ops.flash_attention import launch_flash_fwd

launches = 0


def repack_block(layer: dict, n_heads: int) -> tuple:
    """One layer's [Dm, Dm] q/k/v/out projections (``[in, out]``) and biases
    -> (wqkv_t, bqkv, wo_t). The q columns and bias absorb the softmax scale
    in f32 and are rounded back to the weight dtype, and every bias passes
    through the weight dtype before f32, as ``repack_stacked:260`` does."""
    Dm = layer["q_proj"].shape[0]
    dh = Dm // n_heads
    dt = layer["q_proj"].dtype
    scale = dh**-0.5
    qw = (layer["q_proj"].float() * scale).to(dt)
    qb = (layer["q_bias"].float() * scale).to(dt)
    wqkv_t = torch.cat(
        [qw.t(), layer["k_proj"].t(), layer["v_proj"].t()], dim=0
    ).contiguous()
    bqkv = torch.cat(
        [qb, layer["k_bias"].to(dt), layer["v_bias"].to(dt)]
    ).float()
    wo_t = layer["out_proj"].t().contiguous()
    return wqkv_t, bqkv, wo_t


def fused_block_attention_ref(
    x_ln: torch.Tensor,  # [B, T, Dm]
    wqkv_t: torch.Tensor,
    bqkv: torch.Tensor,
    wo_t: torch.Tensor,
    *,
    n_heads: int,
) -> torch.Tensor:
    """Plain version with the kernels' roundings: qkv rounded to the input
    dtype after the f32 bias (vit_attention.py:67), o/l rounded before the
    out-projection (:87), the out-projection accumulated in f32."""
    B, T, Dm = x_ln.shape
    dh = Dm // n_heads
    dt = x_ln.dtype
    qkv = (x_ln.float() @ wqkv_t.float().t() + bqkv.float()).to(dt)
    q, k, v = qkv.view(B, T, 3, n_heads, dh).unbind(2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bthd", p.to(dt).float(), v.float())
    o = (o / l.permute(0, 2, 1, 3)).to(dt)
    return (o.reshape(B, T, Dm).float() @ wo_t.float().t()).to(dt)


def _gemm(a: torch.Tensor, w_t: torch.Tensor, bias, out: torch.Tensor) -> None:
    M, K = a.shape
    N = w_t.shape[0]
    fn = _kernels.lib("gemm_bias").gemm_bias
    err = fn(
        a.data_ptr(), w_t.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), M, N, K, _kernels.stream_handle(a.device),
    )
    _kernels.check(err, "gemm_bias")


def fused_block_attention(
    x_ln: torch.Tensor,  # [B, T, Dm] -- the LN1 output
    wqkv_t: torch.Tensor,  # [3*Dm, Dm]
    bqkv: torch.Tensor,  # [3*Dm] f32
    wo_t: torch.Tensor,  # [Dm, Dm]
    *,
    n_heads: int,
) -> torch.Tensor:
    """``MHA(x_ln) @ Wo`` for one block: the kernels on CUDA, the plain
    version on the CPU."""
    global launches
    if x_ln.device.type == "cpu":
        return fused_block_attention_ref(
            x_ln, wqkv_t, bqkv, wo_t, n_heads=n_heads
        )
    if x_ln.device.type != "cuda":
        raise ValueError(f"fused_block_attention: unsupported device {x_ln.device}")
    _kernels.forbid_grad("fused_block_attention", x_ln, wqkv_t, bqkv, wo_t)
    B, T, Dm = x_ln.shape
    dh = Dm // n_heads
    for name, x in (("x_ln", x_ln), ("wqkv_t", wqkv_t), ("wo_t", wo_t)):
        if (
            x.dtype != torch.bfloat16
            or not x.is_contiguous()
            or x.device != x_ln.device
            or x.data_ptr() % 16
        ):
            raise ValueError(
                f"fused_block_attention: {name} must be contiguous, 16-byte "
                f"aligned bfloat16 on {x_ln.device}"
            )
    if (
        wqkv_t.shape != (3 * Dm, Dm)
        or wo_t.shape != (Dm, Dm)
        or bqkv.shape != (3 * Dm,)
        or Dm % (8 * n_heads)
    ):
        raise ValueError("fused_block_attention: bad weight shapes")
    if bqkv.dtype != torch.float32 or not bqkv.is_contiguous() or bqkv.device != x_ln.device:
        raise ValueError("fused_block_attention: bqkv must be contiguous float32 on the same device")
    qkv = torch.empty((B, T, 3, n_heads, dh), dtype=x_ln.dtype, device=x_ln.device)
    _gemm(x_ln.view(B * T, Dm), wqkv_t, bqkv, qkv.view(B * T, 3 * Dm))
    o, _ = launch_flash_fwd(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], None, None,
        causal=False, scale=1.0,
    )
    y = torch.empty((B, T, Dm), dtype=x_ln.dtype, device=x_ln.device)
    _gemm(o.view(B * T, Dm), wo_t, None, y.view(B * T, Dm))
    launches += 1
    return y
