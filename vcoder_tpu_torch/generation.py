"""Autoregressive generation (port of ``vcoder_tpu/generation.py``).

Prefill fills a dense KV cache of ``T + max_new_tokens`` slots, then a
Python loop decodes one token per step until every row has emitted EOS or the
budget is spent (the JAX package's fused ``_generate_jit:124`` as a plain
loop). With stop keywords, decode runs in windows and the criteria is checked
on the host between windows (``_generate_windowed:804``).

Sampling: greedy at temperature 0; otherwise temperature then top-p nucleus
filtering, drawn with a ``torch.Generator`` seeded from ``seed`` -- so sampled
tokens differ from JAX's bits; greedy tokens match JAX token for token.
Beam search, speculative decoding and streaming wait for later slices.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Optional, Sequence

import numpy as np
import torch

from vcoder_tpu_torch.config import VCoderConfig
from vcoder_tpu_torch.device import resolve_device
from vcoder_tpu_torch.models import vcoder as model_mod
from vcoder_tpu_torch.models.llama import KVCache
from vcoder_tpu_torch.multimodal import build_splice_plan, validate_features


def nucleus_filter(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Mask logits outside each row's top-p nucleus to -inf (``:35``).
    The first token crossing the threshold is kept, and at least one token
    always is (HF's min_tokens_to_keep=1)."""
    top_p = torch.as_tensor(top_p, dtype=logits.dtype, device=logits.device)
    if top_p.ndim == 1:
        top_p = top_p[:, None]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cumprobs = torch.cumsum(sorted_probs, dim=-1)
    keep = cumprobs - sorted_probs < top_p
    keep[:, 0] = True
    threshold = torch.where(
        keep, sorted_logits, torch.full_like(sorted_logits, float("inf"))
    ).amin(dim=-1, keepdim=True)
    return torch.where(
        logits >= threshold, logits, torch.full_like(logits, float("-inf"))
    )


def sample_token(
    logits: torch.Tensor,  # [B, V] f32
    generator: Optional[torch.Generator],
    *,
    temperature: float,
    top_p: float,
) -> torch.Tensor:
    """Greedy when temperature == 0, else temperature + nucleus sampling."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_p < 1.0:
        logits = nucleus_filter(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_token_batch(
    logits: torch.Tensor,  # [B, V]
    generator: Optional[torch.Generator],
    temperature: torch.Tensor,  # [B] f32; rows <= 0 are greedy
    top_p: torch.Tensor,  # [B] f32; rows >= 1 keep every token
    *,
    nucleus: bool = True,
    sampling: bool = True,
) -> torch.Tensor:
    """Per-row sampling for the serving engines (``generation.py:78``): each
    row draws with its own temperature and top_p. ``nucleus=False`` skips the
    vocabulary sort when no active row restricts top_p; ``sampling=False``
    (no active row samples) returns the greedy tokens without drawing."""
    greedy = torch.argmax(logits, dim=-1)
    if not sampling:
        return greedy
    temperature = temperature.to(logits.device)
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    if nucleus:
        scaled = nucleus_filter(scaled, top_p.to(logits.device))
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=generator)[:, 0]
    return torch.where(temperature > 0.0, sampled, greedy)


@dataclasses.dataclass
class GenerationResult:
    sequences: np.ndarray  # [B, max_new_tokens] generated ids (EOS after the end)
    num_generated: np.ndarray  # [B]
    texts: Optional[list] = None


def _prefill(params, cfg, plan_arrays, images, segs, depths, *, cache_len,
             use_vcoder_emb, attn_impl):
    B = plan_arrays["safe_ids"].shape[0]
    emb = params["lm"]["embed_tokens"]
    cache = KVCache.create(cfg.text, B, cache_len, dtype=emb.dtype, device=emb.device)
    return model_mod.prefill(
        params, cfg, plan_arrays, images, segs, depths,
        cache=cache, use_vcoder_emb=use_vcoder_emb, attn_impl=attn_impl,
    )


def _generate_loop(params, cfg, plan_arrays, images, segs, depths, generator, *,
                   max_new_tokens, temperature, top_p, eos_id, use_vcoder_emb,
                   attn_impl):
    """Prefill, then greedy/sampled decode until all rows hit EOS or the
    budget; the output is EOS-filled past each row's end. Returns
    (tokens [B, max_new_tokens], steps taken)."""
    B, T = plan_arrays["safe_ids"].shape
    logits, cache = _prefill(
        params, cfg, plan_arrays, images, segs, depths,
        cache_len=T + max_new_tokens, use_vcoder_emb=use_vcoder_emb,
        attn_impl=attn_impl,
    )
    tok = sample_token(logits, generator, temperature=temperature, top_p=top_p)
    out_buf = torch.full((B, max_new_tokens), eos_id, dtype=torch.int64, device=tok.device)
    out_buf[:, 0] = tok
    done = tok == eos_id
    step = 1
    while step < max_new_tokens and not bool(done.all()):
        positions = plan_arrays["seq_lens"] + step - 1
        logits, cache = model_mod.decode_step(
            params, cfg, tok, positions, cache, attn_impl=attn_impl
        )
        nxt = sample_token(logits, generator, temperature=temperature, top_p=top_p)
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        out_buf[:, step] = nxt
        done = done | (nxt == eos_id)
        tok = nxt
        step += 1
    return out_buf, step


def _criteria_fires(stopping_criteria, prompt_row, gen_ids) -> bool:
    """Evaluate a KeywordsStoppingCriteria on prompt + generated ids; an
    HF-style (input_ids, scores) criteria is skipped, detected by signature
    (``generation.py:778``)."""
    try:
        sig = inspect.signature(stopping_criteria)
        required = [
            p
            for p in sig.parameters.values()
            if p.default is inspect.Parameter.empty
            and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        ]
        if len(required) > 1:
            return False
    except (TypeError, ValueError):
        pass
    return bool(stopping_criteria(list(prompt_row) + list(gen_ids)))


def _generate_windowed(params, cfg, plan_arrays, images, segs, depths, generator,
                       *, max_new_tokens, temperature, top_p, use_vcoder_emb,
                       attn_impl, stopping_criteria, prompt_ids, window=16):
    """Decode in windows of ``window`` steps, checking stop strings on the
    host between windows; a row that hits a keyword at generated index j has
    its tokens after j cleared to EOS and is frozen."""
    eos = cfg.text.eos_token_id
    B, T = plan_arrays["safe_ids"].shape
    window = max(1, min(window, max_new_tokens))
    n_windows = -(-(max_new_tokens - 1) // window) if max_new_tokens > 1 else 0
    total = 1 + n_windows * window
    logits, cache = _prefill(
        params, cfg, plan_arrays, images, segs, depths, cache_len=T + total,
        use_vcoder_emb=use_vcoder_emb, attn_impl=attn_impl,
    )
    tok = sample_token(logits, generator, temperature=temperature, top_p=top_p)
    seqs = np.full((B, total), eos, np.int64)
    seqs[:, 0] = tok.cpu().numpy()
    done = seqs[:, 0] == eos
    for b in range(B):
        if not done[b] and _criteria_fires(stopping_criteria, prompt_ids[b], seqs[b, :1]):
            done[b] = True

    seq_lens = plan_arrays["seq_lens"]
    done_dev = torch.as_tensor(done, device=tok.device)
    g = 1
    while g < max_new_tokens and not done.all():
        buf = torch.full((B, window), eos, dtype=torch.int64, device=tok.device)
        for step in range(window):
            if bool(done_dev.all()):
                break
            logits, cache = model_mod.decode_step(
                params, cfg, tok, seq_lens + g - 1 + step, cache, attn_impl=attn_impl
            )
            nxt = sample_token(logits, generator, temperature=temperature, top_p=top_p)
            nxt = torch.where(done_dev, torch.full_like(nxt, eos), nxt)
            buf[:, step] = nxt
            done_dev = done_dev | (nxt == eos)
            tok = nxt
        buf_h = buf.cpu().numpy()
        seqs[:, g : g + window] = buf_h
        host_stopped = False
        for b in range(B):
            if done[b]:
                continue
            for j in range(window):
                if int(buf_h[b, j]) == eos:
                    done[b] = True
                    break
                if _criteria_fires(stopping_criteria, prompt_ids[b], seqs[b, : g + j + 1]):
                    seqs[b, g + j + 1 :] = eos
                    done[b] = True
                    host_stopped = True
                    break
        if host_stopped:
            done_dev = torch.as_tensor(done, device=tok.device)
        g += window
    return seqs[:, :max_new_tokens], min(g, max_new_tokens)


def generate(
    params: dict,
    cfg: VCoderConfig,
    input_ids: Sequence[Sequence[int]],
    images: Optional[torch.Tensor] = None,
    segs: Optional[torch.Tensor] = None,
    depths: Optional[torch.Tensor] = None,
    *,
    max_new_tokens: int = 512,
    temperature: float = 0.0,
    top_p: float = 1.0,
    seed: int = 0,
    tokenizer=None,
    stopping_criteria=None,
    is_depth_zero: Optional[Sequence[bool]] = None,
    is_seg_zero: Optional[Sequence[bool]] = None,
    attn_impl: str = "auto",
    pad_to: Optional[int] = None,
) -> GenerationResult:
    """High-level generate (``generation.py:914``): input_ids carry the
    sentinel ids; the splice plan is built here. Runs on the device of the
    parameters (TF32 off on CUDA, see ``device.resolve_device``)."""
    device = resolve_device(params["lm"]["embed_tokens"].device)
    plan = build_splice_plan(
        input_ids,
        num_patches=cfg.vision.num_patches,
        has_image=images is not None,
        has_seg=segs is not None,
        has_depth=depths is not None,
        ds_mode=cfg.model_type == "vcoder_ds_llava",
        it_mode=cfg.model_type == "vcoder_it_llava",
        is_depth_zero=is_depth_zero,
        is_seg_zero=is_seg_zero,
        pad_to=pad_to,
    )
    validate_features(plan, images, segs, depths)
    plan_arrays = model_mod.plan_to_arrays(plan, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    def dev(x):
        return None if x is None else torch.as_tensor(x).to(device)

    images, segs, depths = dev(images), dev(segs), dev(depths)
    common = dict(
        max_new_tokens=max_new_tokens,
        temperature=float(temperature),
        top_p=float(top_p),
        use_vcoder_emb=plan.use_vcoder_emb and cfg.use_vcoder_lm_emb,
        attn_impl=attn_impl,
    )
    if stopping_criteria is not None and getattr(stopping_criteria, "keywords", None):
        seqs, steps = _generate_windowed(
            params, cfg, plan_arrays, images, segs, depths, generator,
            stopping_criteria=stopping_criteria, prompt_ids=input_ids, **common,
        )
    else:
        out_buf, steps = _generate_loop(
            params, cfg, plan_arrays, images, segs, depths, generator,
            eos_id=cfg.text.eos_token_id, **common,
        )
        seqs = out_buf.cpu().numpy()
    return _finalize_result(seqs, steps, cfg, tokenizer, stopping_criteria)


def _finalize_result(seqs: np.ndarray, steps, cfg, tokenizer, stopping_criteria) -> GenerationResult:
    """Per-row first-EOS scan -> num_generated; decode and strip a trailing
    stop keyword -> texts (``generation.py:1072``)."""
    eos = cfg.text.eos_token_id
    num_gen = np.zeros((seqs.shape[0],), np.int64)
    texts = [] if tokenizer is not None else None
    for b in range(seqs.shape[0]):
        row = seqs[b]
        stop = np.nonzero(row == eos)[0]
        n = int(stop[0]) if stop.size else int(steps)
        num_gen[b] = n
        if tokenizer is not None:
            text = tokenizer.decode(row[:n].tolist(), skip_special_tokens=True)
            if stopping_criteria is not None:
                for kw in getattr(stopping_criteria, "keywords", []):
                    if text.endswith(kw):
                        text = text[: -len(kw)]
            texts.append(text.strip())
    return GenerationResult(sequences=seqs, num_generated=num_gen, texts=texts)
