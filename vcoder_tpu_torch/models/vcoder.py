"""Unified VCoder model (port of ``vcoder_tpu/models/vcoder.py``).

* ``encode_vision`` runs the shared CLIP tower ONCE over the stacked
  ``[RGB; seg; depth]`` batch and applies the per-modality projectors.
* ``assemble_embeddings`` consumes a host-built ``SplicePlan`` with two
  gathers and a select.
* ``prefill`` / ``decode_step`` are the inference entry points.

Projector routing quirks kept for checkpoint fidelity (do not "fix"):
``mm2_projector`` replaces ``mm_projector`` when segs are present
(``vcoder.py:179``); depth goes through the *seg* projector
(``:188-191``); text embeds use ``vcoder_lm_emb`` when segs are present
(``:213-217``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vcoder_tpu_torch.config import VCoderConfig
from vcoder_tpu_torch.device import resolve_device
from vcoder_tpu_torch.models import clip as clip_mod
from vcoder_tpu_torch.models import llama as llama_mod
from vcoder_tpu_torch.models.projectors import apply_projector, init_projector_params
from vcoder_tpu_torch.multimodal import SplicePlan


def init_vcoder_params(
    cfg: VCoderConfig,
    *,
    seed: int = 0,
    dtype=torch.bfloat16,
    device="cuda",
) -> dict:
    """Random weights at ``cfg``'s full width, sampled directly in ``dtype``
    on ``device`` from a ``torch.Generator`` seeded with ``seed``. Raises when
    ``device`` is CUDA and there is none."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return build_vcoder_params(cfg, gen, dtype=dtype, device=dev)


def build_vcoder_params(cfg: VCoderConfig, gen: torch.Generator, *, dtype, device) -> dict:
    """The parameter tree of :func:`init_vcoder_params`, drawn from ``gen``
    on ``device`` as given (``"meta"`` gives the shapes alone)."""
    D_v, D_t = cfg.vision.hidden_size, cfg.text.hidden_size
    kw = dict(dtype=dtype, device=device)
    params = {
        "lm": llama_mod.init_llama_params(gen, cfg.text, **kw),
        "vision_tower": clip_mod.init_clip_params(gen, cfg.vision, **kw),
        "mm_projector": init_projector_params(gen, cfg.mm_projector_type, D_v, D_t, **kw),
    }
    if cfg.use_mm2_proj:
        params["mm2_projector"] = init_projector_params(
            gen, cfg.mm_projector_type, D_v, D_t, **kw
        )
    if cfg.use_seg:
        params["seg_projector"] = init_projector_params(
            gen, cfg.seg_mm_projector_type, D_v, D_t, **kw
        )
    if cfg.use_depth:
        params["depth_projector"] = init_projector_params(
            gen, cfg.depth_mm_projector_type, D_v, D_t, **kw
        )
    if cfg.use_vcoder_lm_emb:
        # An independent copy, as the reference clones it
        # (vcoder_llava_arch.py:180).
        params["vcoder_lm_emb"] = params["lm"]["embed_tokens"].clone()
    return params


def encode_vision(
    params: dict,
    cfg: VCoderConfig,
    images: Optional[torch.Tensor],
    segs: Optional[torch.Tensor] = None,
    depths: Optional[torch.Tensor] = None,
    *,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Encode up to three modalities in ONE tower call.

    Pixels are [B, H, W, C], or [B, N, H, W, C] for N sentinel occurrences
    per row. They are cast to the tower's weight dtype, so the tower runs in
    bf16 with bf16 weights whatever dtype the preprocessing emitted.

    Returns the per-sample vision table [B, (N_img + N_seg + N_dep)*576, D_t]
    in the (image, seg, depth) block order ``build_splice_plan`` indexes.
    """

    def _norm(x):
        return None if x is None else (x[:, None] if x.ndim == 4 else x)

    images, segs, depths = _norm(images), _norm(segs), _norm(depths)
    stacks = [x for x in (images, segs, depths) if x is not None]
    if not stacks:
        raise ValueError("encode_vision requires at least one modality")
    B = stacks[0].shape[0]
    hw_c = stacks[0].shape[2:]
    tower_dtype = params["vision_tower"]["patch_embedding"].dtype
    stacked = torch.cat([x.reshape((-1,) + tuple(hw_c)) for x in stacks], dim=0)
    feats = clip_mod.clip_encode(
        params["vision_tower"], cfg.vision, stacked.to(tower_dtype), attn_impl=attn_impl
    )
    P, D_v = feats.shape[1], feats.shape[2]

    def _take(x, offset):
        n = x.shape[1]
        f = feats[offset : offset + B * n]
        return f.reshape(B, n * P, D_v), offset + B * n

    outs = []
    offset = 0
    if images is not None:
        img_f, offset = _take(images, offset)
        if segs is not None and cfg.use_mm2_proj and "mm2_projector" in params:
            outs.append(apply_projector(params["mm2_projector"], img_f))
        else:
            outs.append(apply_projector(params["mm_projector"], img_f))
    if segs is not None:
        seg_f, offset = _take(segs, offset)
        outs.append(apply_projector(params["seg_projector"], seg_f))
    if depths is not None:
        dep_f, offset = _take(depths, offset)
        if cfg.depth_through_seg_projector:
            outs.append(apply_projector(params["seg_projector"], dep_f))
        else:
            outs.append(apply_projector(params["depth_projector"], dep_f))
    return torch.cat(outs, dim=1)


def assemble_embeddings(
    params: dict,
    cfg: VCoderConfig,
    safe_ids: torch.Tensor,  # [B, T]
    is_text: torch.Tensor,  # [B, T] bool
    vis_idx: torch.Tensor,  # [B, T]
    vis_table: Optional[torch.Tensor],  # [B, N_vis, D] or None
    *,
    use_vcoder_emb: bool,
) -> torch.Tensor:
    """Two gathers + select: the whole multimodal splice."""
    table = (
        params["vcoder_lm_emb"]
        if (use_vcoder_emb and "vcoder_lm_emb" in params)
        else params["lm"]["embed_tokens"]
    )
    text_e = table[safe_ids]
    if vis_table is None:
        return text_e
    idx = vis_idx[:, :, None].expand(-1, -1, vis_table.shape[-1])
    vis_e = torch.gather(vis_table, 1, idx)
    return torch.where(is_text[:, :, None], text_e, vis_e.to(text_e.dtype))


def prefill(
    params: dict,
    cfg: VCoderConfig,
    plan_arrays: dict,
    images: Optional[torch.Tensor],
    segs: Optional[torch.Tensor] = None,
    depths: Optional[torch.Tensor] = None,
    *,
    cache: Optional[llama_mod.KVCache] = None,
    use_vcoder_emb: bool = False,
    attn_impl: str = "auto",
) -> Tuple[torch.Tensor, Optional[llama_mod.KVCache]]:
    """Vision encode -> splice -> decoder. Returns (last_logits [B, V] f32,
    the cache, filled in place)."""
    vis_table = None
    if images is not None or segs is not None or depths is not None:
        vis_table = encode_vision(params, cfg, images, segs, depths, attn_impl=attn_impl)
    embeds = assemble_embeddings(
        params,
        cfg,
        plan_arrays["safe_ids"],
        plan_arrays["is_text"],
        plan_arrays["vis_idx"],
        vis_table,
        use_vcoder_emb=use_vcoder_emb,
    )
    hidden, cache = llama_mod.llama_forward(
        params["lm"],
        cfg.text,
        embeds,
        attn_mask=plan_arrays["attn_mask"],
        position_ids=plan_arrays["position_ids"],
        cache=cache,
        write_offset=(
            torch.zeros_like(plan_arrays["seq_lens"]) if cache is not None else None
        ),
        attn_impl=attn_impl,
    )
    last = (plan_arrays["seq_lens"] - 1).clamp_min(0)
    last_hidden = hidden[torch.arange(hidden.shape[0], device=hidden.device), last]
    logits = llama_mod.lm_head(params["lm"], last_hidden[:, None, :])[:, 0]
    return logits, cache


def decode_step(
    params: dict,
    cfg: VCoderConfig,
    token: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B] absolute position of this token
    cache: llama_mod.KVCache,
    *,
    attn_impl: str = "auto",
) -> Tuple[torch.Tensor, llama_mod.KVCache]:
    """One decode step. Returns (logits [B, V] f32, cache)."""
    embeds = llama_mod.embed_tokens(params["lm"], token[:, None])
    hidden, cache = llama_mod.llama_forward(
        params["lm"],
        cfg.text,
        embeds,
        attn_mask=torch.ones_like(token, dtype=torch.bool)[:, None],
        position_ids=positions[:, None],
        cache=cache,
        write_offset=positions,
        attn_impl=attn_impl,
    )
    return llama_mod.lm_head(params["lm"], hidden)[:, 0], cache


def plan_to_arrays(plan: SplicePlan, device="cuda") -> dict:
    """SplicePlan (numpy) -> dict of tensors on ``device``."""
    dev = torch.device(device)

    def t(a, dtype):
        return torch.as_tensor(a, device=dev).to(dtype)

    return {
        "safe_ids": t(plan.safe_ids, torch.int64),
        "is_text": t(plan.is_text, torch.bool),
        "vis_idx": t(plan.vis_idx, torch.int64),
        "attn_mask": t(plan.attn_mask, torch.bool),
        "position_ids": t(plan.position_ids, torch.int64),
        "seq_lens": t(plan.seq_lens, torch.int64),
    }
