"""The CLIP block's kernels: the attention block and the MLP half-block, with
their plain PyTorch versions.

Port of ``vcoder_tpu/ops/vit_attention.py``: ``fused_block_attention:102``
over the TPU kernel ``_block_kernel:52``, and ``fused_block_mlp:191`` over
``_mlp_kernel:154``. One attention call computes
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

The MLP half-block, :func:`fused_block_mlp`, computes
``x + fc2(quick_gelu(fc1(LN2(x))))`` with the TPU kernel's roundings (its
plain version is :func:`fused_block_mlp_ref`, not the tower's unfused
``_mlp``, which rounds after fc1): on CUDA the three launches of
``csrc/vit_mlp.cu`` (LN2, fc1 with the bias + quick-GELU epilogue into a
bf16 ``[B*T, I]`` intermediate, fc2 with the residual + bias epilogue).
``launches_mlp`` counts the calls that launched them.

All four GEMMs are one pipelined Hopper mainloop (``csrc/gemm_sm90.cuh``:
TMA into a ring of shared-memory stages, wgmma, one epilogue per use), and
every weight is read in its parameter layout, ``[in, out]``.

Weight layout (:func:`repack_block`): ``wqkv [Dm, 3*Dm]`` (columns: q|k|v
outputs, head-major inside each), ``bqkv [3*Dm]`` f32, ``wo [Dm, Dm]`` --
the stored ``out_proj`` itself.
"""

from __future__ import annotations

import torch

from vcoder_tpu_torch.ops import _kernels
from vcoder_tpu_torch.ops.flash_attention import launch_flash_fwd

launches = 0
launches_mlp = 0

# vit_mlp_gemm's epilogues (csrc/gemm_sm90.cuh).
_EPI_BIAS_GELU, _EPI_RESIDUAL_BIAS = 1, 2


def repack_block(layer: dict, n_heads: int) -> tuple:
    """One layer's [Dm, Dm] q/k/v/out projections (``[in, out]``) and biases
    -> (wqkv, bqkv, wo). The q columns and bias absorb the softmax scale in
    f32 and are rounded back to the weight dtype, and every bias passes
    through the weight dtype before f32, as ``repack_stacked:260`` does; one
    column concatenation, no transpose, and ``wo`` is ``out_proj`` as
    stored."""
    Dm = layer["q_proj"].shape[0]
    dh = Dm // n_heads
    dt = layer["q_proj"].dtype
    scale = dh**-0.5
    qw = (layer["q_proj"].float() * scale).to(dt)
    qb = (layer["q_bias"].float() * scale).to(dt)
    wqkv = torch.cat([qw, layer["k_proj"], layer["v_proj"]], dim=1)
    bqkv = torch.cat(
        [qb, layer["k_bias"].to(dt), layer["v_bias"].to(dt)]
    ).float()
    return wqkv, bqkv, layer["out_proj"]


def fused_block_attention_ref(
    x_ln: torch.Tensor,  # [B, T, Dm]
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wo: torch.Tensor,
    *,
    n_heads: int,
) -> torch.Tensor:
    """Plain version with the kernels' roundings: qkv rounded to the input
    dtype after the f32 bias (vit_attention.py:67), o/l rounded before the
    out-projection (:87), the out-projection accumulated in f32."""
    B, T, Dm = x_ln.shape
    dh = Dm // n_heads
    dt = x_ln.dtype
    qkv = (x_ln.float() @ wqkv.float() + bqkv.float()).to(dt)
    q, k, v = qkv.view(B, T, 3, n_heads, dh).unbind(2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bthd", p.to(dt).float(), v.float())
    o = (o / l.permute(0, 2, 1, 3)).to(dt)
    return (o.reshape(B, T, Dm).float() @ wo.float()).to(dt)


def launch_gemm_bias(a: torch.Tensor, w: torch.Tensor, bias, out: torch.Tensor) -> None:
    """``out[M, N] = bf16(a[M, K] @ w[K, N] + bias)`` by ``csrc/gemm_bias.cu``;
    ``bias`` f32 ``[N]`` or None. The caller checks types, contiguity and
    16-byte alignment."""
    M, K = a.shape
    N = out.shape[1]
    err = _kernels.lib("gemm_bias").gemm_bias(
        a.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), M, N, K, _kernels.stream_handle(a.device),
    )
    _kernels.check(err, "gemm_bias")


def fused_block_attention(
    x_ln: torch.Tensor,  # [B, T, Dm] -- the LN1 output
    wqkv: torch.Tensor,  # [Dm, 3*Dm]
    bqkv: torch.Tensor,  # [3*Dm] f32
    wo: torch.Tensor,  # [Dm, Dm]
    *,
    n_heads: int,
) -> torch.Tensor:
    """``MHA(x_ln) @ Wo`` for one block: the kernels on CUDA, the plain
    version on the CPU."""
    global launches
    if x_ln.device.type == "cpu":
        return fused_block_attention_ref(
            x_ln, wqkv, bqkv, wo, n_heads=n_heads
        )
    if x_ln.device.type != "cuda":
        raise ValueError(f"fused_block_attention: unsupported device {x_ln.device}")
    _kernels.forbid_grad("fused_block_attention", x_ln, wqkv, bqkv, wo)
    B, T, Dm = x_ln.shape
    dh = Dm // n_heads
    for name, x in (("x_ln", x_ln), ("wqkv", wqkv), ("wo", wo)):
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
        wqkv.shape != (Dm, 3 * Dm)
        or wo.shape != (Dm, Dm)
        or bqkv.shape != (3 * Dm,)
        or Dm % (8 * n_heads)
    ):
        raise ValueError("fused_block_attention: bad weight shapes")
    if bqkv.dtype != torch.float32 or not bqkv.is_contiguous() or bqkv.device != x_ln.device:
        raise ValueError("fused_block_attention: bqkv must be contiguous float32 on the same device")
    qkv = torch.empty((B, T, 3, n_heads, dh), dtype=x_ln.dtype, device=x_ln.device)
    launch_gemm_bias(x_ln.view(B * T, Dm), wqkv, bqkv, qkv.view(B * T, 3 * Dm))
    o, _ = launch_flash_fwd(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], None, None,
        causal=False, scale=1.0,
    )
    y = torch.empty((B, T, Dm), dtype=x_ln.dtype, device=x_ln.device)
    launch_gemm_bias(o.view(B * T, Dm), wo, None, y.view(B * T, Dm))
    launches += 1
    return y


def pick_i_block(intermediate: int) -> int:
    """The I-stripe of the plain version's loop (``pick_i_block:304``):
    the largest of 512, 256, 128 that divides the MLP width, else all of it.
    The CUDA kernels do not stripe I; the f32 sum over I makes the order
    immaterial within tolerance."""
    for ib in (512, 256, 128):
        if intermediate % ib == 0:
            return ib
    return intermediate


def fused_block_mlp_ref(x, ln_scale, ln_bias, fc1, fc1_bias, fc2, fc2_bias, *, eps: float,
                        i_block: int = 512) -> torch.Tensor:
    """Plain version with the TPU kernel's roundings: LN2 statistics in f32,
    the normalized row rounded once to the activation dtype; fc1 in f32 plus
    its bias, quick-GELU in f32, rounded to the activation dtype before fc2;
    fc2 accumulated in f32 over I stripes of ``i_block``; ``(x + acc) + b2``
    in f32, rounded once."""
    dt = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    h = ((x32 - mean) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()).to(dt)
    I = fc1.shape[1]
    if I % i_block:
        raise ValueError(f"i_block {i_block} does not divide the MLP width {I}")
    acc = torch.zeros(x32.shape, dtype=torch.float32, device=x.device)
    for i0 in range(0, I, i_block):
        t = h.float() @ fc1[:, i0 : i0 + i_block].float() + fc1_bias[i0 : i0 + i_block].float()
        t = t * torch.sigmoid(1.702 * t)
        acc = acc + t.to(dt).float() @ fc2[i0 : i0 + i_block].float()
    return (x32 + acc + fc2_bias.float()).to(dt)


def fused_block_mlp(
    x: torch.Tensor,  # [B, T, Dm] block input (the post-attention residual)
    ln_scale: torch.Tensor,  # [Dm]
    ln_bias: torch.Tensor,  # [Dm]
    fc1: torch.Tensor,  # [Dm, I]
    fc1_bias: torch.Tensor,  # [I]
    fc2: torch.Tensor,  # [I, Dm]
    fc2_bias: torch.Tensor,  # [Dm]
    *,
    eps: float,
    i_block: int = 512,
) -> torch.Tensor:
    """One ViT MLP half-block, ``x + fc2(quick_gelu(fc1(LN(x))))``: the
    kernels on CUDA (bf16 x, fc1 and fc2; LN parameters and biases of any
    float type, f32 and bf16 read as stored, the arithmetic in f32), the
    plain version on the CPU. ``i_block`` only sets the plain version's
    loop."""
    global launches_mlp
    if x.device.type == "cpu":
        return fused_block_mlp_ref(x, ln_scale, ln_bias, fc1, fc1_bias, fc2, fc2_bias, eps=eps,
                                   i_block=i_block)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_mlp: unsupported device {x.device}")
    _kernels.forbid_grad("fused_block_mlp", x, ln_scale, ln_bias, fc1, fc1_bias, fc2, fc2_bias)
    B, T, Dm = x.shape
    I = fc1.shape[1]
    for name, t, shape in (("x", x, (B, T, Dm)), ("fc1", fc1, (Dm, I)), ("fc2", fc2, (I, Dm))):
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != x.device or t.data_ptr() % 16):
            raise ValueError(f"fused_block_mlp: {name} must be a contiguous, 16-byte aligned "
                             f"bfloat16 {shape} on {x.device}")
    if Dm % 8 or I % 8:
        raise ValueError(f"fused_block_mlp: widths {Dm}, {I} must be multiples of 8")
    for name, t, n in (("ln_scale", ln_scale, Dm), ("ln_bias", ln_bias, Dm),
                       ("fc1_bias", fc1_bias, I), ("fc2_bias", fc2_bias, Dm)):
        if tuple(t.shape) != (n,) or t.device != x.device or not t.is_floating_point():
            raise ValueError(f"fused_block_mlp: {name} must be a float [{n}] on {x.device}")
    # The kernels read f32 or bf16 vectors as stored (bf16 widens exactly);
    # anything else is widened to f32 here. The LN pair shares one type.
    s, b = _as_vectors(ln_scale, ln_bias)
    (b1,), (b2,) = _as_vectors(fc1_bias), _as_vectors(fc2_bias)
    M = B * T
    h = torch.empty((M, Dm), dtype=x.dtype, device=x.device)
    g = torch.empty((M, I), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    x2 = x.view(M, Dm)
    launch_layer_norm(x2, s, b, h, eps)
    launch_mlp_gemm(h, fc1, b1, None, g, gelu=True)
    launch_mlp_gemm(g, fc2, b2, x2, y.view(M, Dm), gelu=False)
    launches_mlp += 1
    return y


def _as_vectors(*vecs):
    """``vecs`` as the kernels read them: all f32 or all bf16, contiguous and
    16-byte aligned; widened to f32 (one copy each) only where they are not."""
    dt = vecs[0].dtype
    if dt in (torch.float32, torch.bfloat16) and all(
            v.dtype == dt and v.is_contiguous() and v.data_ptr() % 16 == 0 for v in vecs):
        return vecs
    return tuple(v.float().contiguous() for v in vecs)


def launch_layer_norm(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
                      eps: float) -> None:
    """``h = bf16(LN(x) * s + b)`` by ``csrc/vit_mlp.cu``'s LN kernel: x and h
    bf16 ``[M, Dm]``; s and b ``[Dm]``, both f32 or both bf16. The caller
    checks the inputs."""
    M, Dm = x.shape
    err = _kernels.lib("vit_mlp").vit_mlp_ln(
        x.data_ptr(), s.data_ptr(), b.data_ptr(), h.data_ptr(), M, Dm, float(eps),
        int(s.dtype == torch.bfloat16), _kernels.stream_handle(x.device),
    )
    _kernels.check(err, "vit_mlp")


def launch_mlp_gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, res, out: torch.Tensor,
                    *, gelu: bool) -> None:
    """``csrc/vit_mlp.cu``'s GEMMs: ``out = bf16(quick_gelu(a @ w + bias))``
    (fc1, ``gelu``) or ``out = bf16((res + a @ w) + bias)`` (fc2), ``w``
    ``[K, N]``, ``bias`` f32 or bf16. The caller checks the inputs."""
    M, K = a.shape
    N = out.shape[1]
    err = _kernels.lib("vit_mlp").vit_mlp_gemm(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), int(bias.dtype == torch.bfloat16),
        None if res is None else res.data_ptr(), out.data_ptr(), M, N, K,
        _EPI_BIAS_GELU if gelu else _EPI_RESIDUAL_BIAS, _kernels.stream_handle(a.device),
    )
    _kernels.check(err, "vit_mlp")
