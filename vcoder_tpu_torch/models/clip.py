"""CLIP ViT vision tower (port of ``vcoder_tpu/models/clip.py``).

* The patch embedding is a matmul over patches flattened in (C, ph, pw)
  order, the flattening of HF's Conv2d weight (``clip.py:86-98``).
* CLS is concatenated, then the position embedding is added, then the
  pre-layernorm; LayerNorm uses the population variance (``:72-78``).
* ``select_layer=-2`` runs ``num_layers - 1`` blocks and skips the last block
  and the post-layernorm (``:101-109``); CLS is dropped after (``:197-198``).
* With ``attn_impl`` "auto" and plain attention weights the blocks take the
  fused attention-block route (``ops/vit_attention.py``: the CUDA kernels on
  CUDA, the plain version on the CPU), and the caller adds the out bias and
  the residual (``:277``). The MLP stays ``qmatmul`` (``FUSE_MLP_DEFAULT=False``,
  ``:118``). ``attn_impl="xla"``, or quantized attention weights, run the
  unfused blocks through the attention dispatcher.
"""

from __future__ import annotations

import torch

from vcoder_tpu_torch.config import VisionConfig
from vcoder_tpu_torch.ops.attention import multi_head_attention
from vcoder_tpu_torch.ops.quant import qmatmul as qm
from vcoder_tpu_torch.ops.vit_attention import fused_block_attention, repack_block


def init_clip_params(
    generator: torch.Generator, cfg: VisionConfig, *, dtype=torch.float32, device="cpu"
) -> dict:
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    P, C = cfg.patch_size, cfg.num_channels

    def nrm(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(0.02)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "class_embedding": nrm(D),
        "patch_embedding": nrm(P * P * C, D),
        "position_embedding": nrm(cfg.num_positions, D),
        "pre_layernorm": {"scale": ones(D), "bias": zeros(D)},
        "layers": {
            "ln1_scale": ones(L, D),
            "ln1_bias": zeros(L, D),
            "ln2_scale": ones(L, D),
            "ln2_bias": zeros(L, D),
            "q_proj": nrm(L, D, D),
            "q_bias": zeros(L, D),
            "k_proj": nrm(L, D, D),
            "k_bias": zeros(L, D),
            "v_proj": nrm(L, D, D),
            "v_bias": zeros(L, D),
            "out_proj": nrm(L, D, D),
            "out_bias": zeros(L, D),
            "fc1": nrm(L, D, I),
            "fc1_bias": zeros(L, I),
            "fc2": nrm(L, I, D),
            "fc2_bias": zeros(L, D),
        },
    }


def layer_norm(x, scale, bias, eps):
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * scale + bias).to(dtype)


def quick_gelu(x):
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/P)*(W/P), C*P*P], each patch flattened (C, ph, pw)."""
    B, H, W, C = images.shape
    P = patch_size
    x = images.reshape(B, H // P, P, W // P, P, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, (H // P) * (W // P), C * P * P)


def _num_blocks(cfg: VisionConfig) -> int:
    sl = cfg.select_layer
    n_blocks = cfg.num_layers + 1 + sl if sl < 0 else sl
    if not (0 <= n_blocks <= cfg.num_layers):
        raise ValueError(f"select_layer {sl} out of range")
    return n_blocks


def _layer(params: dict, l: int) -> dict:
    return {k: v[l] for k, v in params["layers"].items()}


def _mlp(x, lp, eps):
    h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps)
    return x + (qm(quick_gelu(qm(h, lp["fc1"]) + lp["fc1_bias"]), lp["fc2"]) + lp["fc2_bias"])


def _fused_eligible(params: dict, attn_impl: str) -> bool:
    """The fused attention-block route (``clip.py:121-157``) takes plain
    attention weights only: quantized ones go through ``_run_blocks``, whose
    ``qmatmul`` handles them (the MLP runs through ``qmatmul`` on both
    routes). JAX's TPU-only conditions (backend, mesh, Mosaic tiling) have
    no counterpart here."""
    lp = params["layers"]
    return attn_impl == "auto" and all(
        isinstance(lp[k], torch.Tensor) for k in ("q_proj", "k_proj", "v_proj", "out_proj")
    )


def clip_encode(
    params: dict, cfg: VisionConfig, images: torch.Tensor, *, attn_impl: str = "auto"
) -> torch.Tensor:
    """[B, H, W, C] preprocessed channel-last pixels -> [B, num_patches(+1), D]
    patch features at ``cfg.select_layer`` (CLS dropped for 'patch')."""
    B = images.shape[0]
    D = cfg.hidden_size
    eps = cfg.layer_norm_eps

    x = qm(patchify(images, cfg.patch_size), params["patch_embedding"])
    cls = params["class_embedding"].to(x.dtype).expand(B, 1, D)
    x = torch.cat([cls, x], dim=1)
    x = x + params["position_embedding"][None]
    x = layer_norm(
        x, params["pre_layernorm"]["scale"], params["pre_layernorm"]["bias"], eps
    )

    n_blocks = _num_blocks(cfg)
    if _fused_eligible(params, attn_impl):
        x = _run_blocks_fused(params, cfg, x, n_blocks)
    else:
        x = _run_blocks(params, cfg, x, n_blocks, attn_impl)

    if cfg.select_feature == "patch":
        return x[:, 1:, :]
    if cfg.select_feature == "cls_patch":
        return x
    raise ValueError(f"Unexpected select feature: {cfg.select_feature}")


def _run_blocks(params, cfg, x, n_blocks, attn_impl):
    """Unfused blocks through the attention dispatcher (``clip.py:204``)."""
    B, T, D = x.shape
    H, HD = cfg.num_heads, cfg.head_dim
    eps = cfg.layer_norm_eps
    for l in range(n_blocks):
        lp = _layer(params, l)
        h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps)
        q = (qm(h, lp["q_proj"]) + lp["q_bias"]).reshape(B, T, H, HD)
        k = (qm(h, lp["k_proj"]) + lp["k_bias"]).reshape(B, T, H, HD)
        v = (qm(h, lp["v_proj"]) + lp["v_bias"]).reshape(B, T, H, HD)
        attn = multi_head_attention(q, k, v, causal=False, impl=attn_impl)
        x = x + (qm(attn.reshape(B, T, D), lp["out_proj"]) + lp["out_bias"])
        x = _mlp(x, lp, eps)
    return x


def _run_blocks_fused(params, cfg, x, n_blocks):
    """Blocks with the fused attention block (``clip.py:232``): one
    ``fused_block_attention`` call per layer on the LN1 output; the weight
    layout is built per call, as the JAX package repacks in-graph."""
    H = cfg.num_heads
    eps = cfg.layer_norm_eps
    for l in range(n_blocks):
        lp = _layer(params, l)
        h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps)
        wqkv_t, bqkv, wo_t = repack_block(lp, H)
        a = fused_block_attention(h, wqkv_t, bqkv, wo_t, n_heads=H)
        x = x + a + lp["out_bias"]
        x = _mlp(x, lp, eps)
    return x
