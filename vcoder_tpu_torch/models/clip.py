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
  the residual (``:277``). The MLP stays ``qmatmul`` unless
  :data:`FUSE_MLP_DEFAULT` is set (``:118``, False as in JAX): then each
  block's MLP half is ``fused_block_mlp`` (``:278-283``), and the route also
  needs plain fc1/fc2 weights (``:152-156``). ``clip_encode`` reads the flag
  at call time; the JAX package binds it as a default argument when the
  module is imported (``:123,233``), so there only a direct call of
  ``_run_blocks_fused(fuse_mlp=True)`` reaches its kernel.
  ``attn_impl="xla"``, quantized attention weights, or a tower
  that autograd differentiates (a stage that trains it, ``"all"``: the fused
  kernel has no backward) run the unfused blocks through the attention
  dispatcher, which is plain differentiable torch at the tower's head dim.
* Over a distributed mesh the tower takes the unfused blocks, as JAX's
  ``clip.py:138-140`` does (so K2 and K9 are not launched there): each
  layer's weights are gathered whole at use (``parallel/spmd.py``) and the
  tower runs replicated over ``model`` on the rank's rows. It is 0.3 B of
  VCoder-DS-7B's 7.3 B parameters; split over ``model``, any reordering of
  its sums moves the decoder's logits by ~0.05 relative L2 at random
  weights (``scripts/row_split_check.py``); replicated, it computes what
  the one-device unfused tower computes on the same rows. A quantized
  tower is gathered the same way, field by field (JAX ``clip.py:136-144``),
  and takes its W8A8 products whole on every rank.
"""

from __future__ import annotations

import torch

from vcoder_tpu_torch.config import VisionConfig
from vcoder_tpu_torch.ops.attention import multi_head_attention
from vcoder_tpu_torch.ops.quant import qmatmul as qm
from vcoder_tpu_torch.parallel import spmd
from vcoder_tpu_torch.ops.vit_attention import (
    fused_block_attention,
    fused_block_mlp,
    pick_i_block,
    repack_block,
)

#: Run each fused block's MLP half through ``fused_block_mlp``; read by
#: ``clip_encode`` at call time.
FUSE_MLP_DEFAULT = False
#: Let eligible towers take the fused attention-block route; read by
#: ``clip_encode`` at call time. False sends every tower through the unfused
#: blocks, the route a mesh takes (a one-device reference for a mesh's
#: numbers sets it).
FUSED_BLOCKS = True


def init_clip_params(
    generator: torch.Generator, cfg: VisionConfig, *, dtype=torch.float32, device="cpu",
    place=None,
) -> dict:
    """Random-normal (0.02) weights, unit LayerNorm scales and zero biases;
    ``place(path, leaf)``, when given, takes each leaf as it is made."""
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    P, C = cfg.patch_size, cfg.num_channels
    put = place or (lambda _path, t: t)

    def nrm(path, *shape):
        return put(path, torch.randn(shape, generator=generator, dtype=dtype,
                                     device=device).mul_(0.02))

    def ones(path, *shape):
        return put(path, torch.ones(shape, dtype=dtype, device=device))

    def zeros(path, *shape):
        return put(path, torch.zeros(shape, dtype=dtype, device=device))

    return {
        "class_embedding": nrm("class_embedding", D),
        "patch_embedding": nrm("patch_embedding", P * P * C, D),
        "position_embedding": nrm("position_embedding", cfg.num_positions, D),
        "pre_layernorm": {"scale": ones("pre_layernorm/scale", D),
                          "bias": zeros("pre_layernorm/bias", D)},
        "layers": {
            "ln1_scale": ones("layers/ln1_scale", L, D),
            "ln1_bias": zeros("layers/ln1_bias", L, D),
            "ln2_scale": ones("layers/ln2_scale", L, D),
            "ln2_bias": zeros("layers/ln2_bias", L, D),
            "q_proj": nrm("layers/q_proj", L, D, D),
            "q_bias": zeros("layers/q_bias", L, D),
            "k_proj": nrm("layers/k_proj", L, D, D),
            "k_bias": zeros("layers/k_bias", L, D),
            "v_proj": nrm("layers/v_proj", L, D, D),
            "v_bias": zeros("layers/v_bias", L, D),
            "out_proj": nrm("layers/out_proj", L, D, D),
            "out_bias": zeros("layers/out_bias", L, D),
            "fc1": nrm("layers/fc1", L, D, I),
            "fc1_bias": zeros("layers/fc1_bias", L, I),
            "fc2": nrm("layers/fc2", L, I, D),
            "fc2_bias": zeros("layers/fc2_bias", L, D),
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
    return spmd.layer(params["layers"], l)


def _mlp(x, lp, eps):
    h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps)
    return x + (qm(quick_gelu(qm(h, lp["fc1"]) + lp["fc1_bias"]), lp["fc2"]) + lp["fc2_bias"])


def _fused_eligible(params: dict, attn_impl: str, differentiate: bool,
                    fuse_mlp: bool = False) -> bool:
    """The fused attention-block route (``clip.py:121-157``) takes plain
    attention weights only: quantized ones go through ``_run_blocks``, whose
    ``qmatmul`` handles them. With ``fuse_mlp`` it takes plain fc1/fc2 only
    (the MLP kernel reads them as tensors); without, the MLP runs through
    ``qmatmul`` on both routes. Nor does it take a tower that autograd
    differentiates (``differentiate``, decided by the caller): the kernels
    have no backward. JAX's TPU-only conditions (backend, mesh, Mosaic
    tiling) have no counterpart here."""
    lp = params["layers"]
    names = ("q_proj", "k_proj", "v_proj", "out_proj") + (("fc1", "fc2") if fuse_mlp else ())
    plain = all(isinstance(lp[k], torch.Tensor) for k in names)
    return (attn_impl == "auto" and plain and not differentiate and FUSED_BLOCKS
            and spmd.mesh() is None)


def clip_encode(
    params: dict,
    cfg: VisionConfig,
    images: torch.Tensor,
    *,
    attn_impl: str = "auto",
    differentiate: bool = False,
) -> torch.Tensor:
    """[B, H, W, C] preprocessed channel-last pixels -> [B, num_patches(+1), D]
    patch features at ``cfg.select_layer`` (CLS dropped for 'patch').
    ``differentiate``: autograd differentiates the tower (a stage trains it),
    so the unfused blocks run; a fused call on inputs that require grad
    raises on CUDA (``ops/vit_attention.py``)."""
    B = images.shape[0]
    D = cfg.hidden_size
    eps = cfg.layer_norm_eps

    x = qm(patchify(images, cfg.patch_size), spmd.weight(params["patch_embedding"], None))
    cls = spmd.weight(params["class_embedding"]).to(x.dtype).expand(B, 1, D)
    x = torch.cat([cls, x], dim=1)
    x = x + spmd.weight(params["position_embedding"], None)[None]
    pre = params["pre_layernorm"]
    x = layer_norm(x, spmd.weight(pre["scale"]), spmd.weight(pre["bias"]), eps)

    n_blocks = _num_blocks(cfg)
    fuse_mlp = FUSE_MLP_DEFAULT
    if _fused_eligible(params, attn_impl, differentiate, fuse_mlp):
        x = _run_blocks_fused(params, cfg, x, n_blocks, fuse_mlp=fuse_mlp)
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


def _run_blocks_fused(params, cfg, x, n_blocks, *, fuse_mlp: bool = False):
    """Blocks with the fused attention block (``clip.py:232``): one
    ``fused_block_attention`` call per layer on the LN1 output; the weight
    layout is built per call, as the JAX package repacks in-graph. With
    ``fuse_mlp`` the MLP half is one ``fused_block_mlp`` call per layer."""
    H = cfg.num_heads
    eps = cfg.layer_norm_eps
    ib = pick_i_block(cfg.intermediate_size)
    for l in range(n_blocks):
        lp = _layer(params, l)
        h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps)
        wqkv, bqkv, wo = repack_block(lp, H)
        a = fused_block_attention(h, wqkv, bqkv, wo, n_heads=H)
        x = x + a + lp["out_bias"]
        if fuse_mlp:
            x = fused_block_mlp(x, lp["ln2_scale"], lp["ln2_bias"], lp["fc1"], lp["fc1_bias"],
                                lp["fc2"], lp["fc2_bias"], eps=eps, i_block=ib)
        else:
            x = _mlp(x, lp, eps)
    return x
