"""Autoregressive generation (port of ``vcoder_tpu/generation.py``).

Prefill fills a dense KV cache of ``T + max_new_tokens`` slots, then a
Python loop decodes one token per step until every row has emitted EOS or the
budget is spent (the JAX package's fused ``_generate_jit:124`` as a plain
loop). With stop keywords, decode runs in windows and the criteria is checked
on the host between windows (``_generate_windowed:804``).

Sampling: greedy at temperature 0; otherwise temperature then top-p nucleus
filtering, drawn with a ``torch.Generator`` seeded from ``seed`` -- so sampled
tokens differ from JAX's bits; greedy tokens match JAX token for token.

The other modes of ``generate`` (``:914-1070``):

* ``lookahead >= 2`` at temperature 0 without stopping criteria runs
  prompt-lookup speculative decoding (``speculative.generate_speculative``):
  greedy's tokens from fewer decoder dispatches.
* ``num_beams > 1`` runs HF-semantics beam search (:func:`_beam_generate`,
  ``_beam_generate_jit:198``); stop keywords are stripped from the text
  afterwards.
* :func:`generate_stream` (``:589``) yields the accumulated text after each
  token (batch 1); with ``lookahead >= 2`` at temperature 0 it streams the
  speculative path's accepted tokens from a worker thread. A failure in that
  thread is re-raised in the consumer (JAX ends the stream as if complete).
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


def _prepare_inputs(params, cfg, input_ids, images, segs, depths, *, is_depth_zero=None,
                    is_seg_zero=None, pad_to=None):
    """The splice plan and the device inputs every generation path starts
    from: (device, plan, plan arrays, images, segs, depths), the pixels moved
    to the device of the parameters (TF32 off on CUDA, see
    ``device.resolve_device``)."""
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

    def dev(x):
        return None if x is None else torch.as_tensor(x).to(device)

    return (device, plan, model_mod.plan_to_arrays(plan, device), dev(images), dev(segs),
            dev(depths))


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


def _topk(x: torch.Tensor, k: int):
    """Top-k along the last axis with ties in index order, as
    ``jax.lax.top_k`` orders them (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _beam_select(s, logprobs, scores, out_buf, fin_scores, fin_out, done, *, eos_id,
                 length_penalty, noise=None):
    """One HF ``BeamSearchScorer.process`` step at generated index ``s``
    (``generation.py:318``). logprobs [B, W, V]; scores [B, W]; out_buf and
    fin_out [B, W, M]; fin_scores [B, W]; done [B]. Ranks the top 2W
    (parent, token) candidates (by ``total + noise`` in beam-sample mode,
    keeping the true scores); EOS candidates ranked < W retire into the
    top-W finished set, normalized by ``(s + 1) ** length_penalty``; the
    first W non-EOS candidates live on. Done batch items are frozen (parent
    = identity). Returns (scores, tokens, parent, out_buf, fin_scores,
    fin_out, done)."""
    B, W, V = logprobs.shape
    dev = logprobs.device
    neg_inf = torch.tensor(float("-inf"), device=dev)
    barange = torch.arange(B, device=dev)[:, None]
    flat = (scores[:, :, None] + logprobs).reshape(B, W * V)
    if noise is not None:
        _, top_ix = _topk(flat + noise, 2 * W)
        top_sc = torch.gather(flat, 1, top_ix)
    else:
        top_sc, top_ix = _topk(flat, 2 * W)
    parent = top_ix // V
    tok = top_ix % V
    is_eos = tok == eos_id
    # Normalized by the GENERATED length including the EOS (transformers
    # >= 4.49); the prompt length does not enter.
    norm = torch.tensor(float(s + 1), dtype=torch.float32, device=dev) ** length_penalty
    rank_ok = torch.arange(2 * W, device=dev)[None, :] < W
    cand_fin = torch.where(is_eos & rank_ok & ~done[:, None], top_sc / norm, neg_inf)
    # The parent's sequence so far (positions >= s still EOS-filled: exactly
    # the finished representation).
    cand_buf = out_buf[barange, parent]  # [B, 2W, M]
    merged_buf = torch.cat([fin_out, cand_buf], dim=1)
    new_fin_scores, sel_ix = _topk(torch.cat([fin_scores, cand_fin], dim=1), W)
    new_fin_out = merged_buf[barange, sel_ix]
    new_scores, live_ix = _topk(torch.where(is_eos, neg_inf, top_sc), W)
    new_parent = torch.gather(parent, 1, live_ix)
    new_tok = torch.gather(tok, 1, live_ix)
    new_out = out_buf[barange, new_parent]
    new_out[:, :, s] = new_tok
    # Done when W hypotheses are banked and the best live beam, normalized
    # at the current length, cannot displace the worst (early_stopping=False).
    new_done = done | (new_fin_scores[:, W - 1] >= new_scores[:, 0] / norm)
    keep = done[:, None]
    return (
        torch.where(keep, scores, new_scores),
        torch.where(keep, torch.zeros_like(new_tok), new_tok),
        torch.where(keep, torch.arange(W, device=dev)[None, :], new_parent),
        torch.where(keep[:, :, None], out_buf, new_out),
        torch.where(keep, fin_scores, new_fin_scores),
        torch.where(keep[:, :, None], fin_out, new_fin_out),
        new_done,
    )


def _beam_generate(params, cfg, plan_arrays, images, segs, depths, generator, *,
                   max_new_tokens, num_beams, length_penalty, eos_id, use_vcoder_emb,
                   attn_impl, temperature=0.0, top_p=1.0) -> torch.Tensor:
    """Beam search with HF ``generate(num_beams=W)`` semantics
    (``_beam_generate_jit:198``; length_penalty, early_stopping=False). The
    prefill runs once at batch B; the cache is repeated to B*W rows (row
    ``b*W + w``) and each step reorders it by parent beam with an
    ``index_select`` on the batch axis of ``[L, B, S, KH, HD]``, then decodes
    one token per beam and runs :func:`_beam_select`. At ``temperature > 0``
    (HF's beam-sample mode) log-probs are scaled by 1/T, nucleus-filtered
    when ``top_p < 1``, and the 2W candidates are drawn without replacement
    by Gumbel top-k from ``generator`` (HF's distribution, other bits).
    Returns the best sequence per batch item [B, max_new_tokens],
    EOS-filled past its end."""
    B, T = plan_arrays["safe_ids"].shape
    W, M = num_beams, max_new_tokens
    logits, cache = _prefill(params, cfg, plan_arrays, images, segs, depths, cache_len=T + M,
                             use_vcoder_emb=use_vcoder_emb, attn_impl=attn_impl)
    cache = KVCache(
        k=cache.k.repeat_interleave(W, dim=1),
        v=cache.v.repeat_interleave(W, dim=1),
        kv_mask=cache.kv_mask.repeat_interleave(W, dim=0),
        length=cache.length.repeat_interleave(W, dim=0),
    )
    dev = logits.device
    V = logits.shape[-1]
    do_sample = temperature > 0.0

    def warp(lps):
        if not do_sample:
            return lps
        lps = lps / torch.tensor(temperature, dtype=torch.float32, device=dev)
        return nucleus_filter(lps, top_p) if top_p < 1.0 else lps

    def noise():
        if not do_sample:
            return None
        e = torch.empty((B, W * V), dtype=torch.float32, device=dev)
        return -e.exponential_(generator=generator).log()  # Gumbel(0, 1)

    sel = dict(eos_id=eos_id, length_penalty=length_penalty)
    lp0 = warp(torch.log_softmax(logits.float(), dim=-1))
    neg_inf = float("-inf")
    warange = torch.arange(W, device=dev)
    scores = torch.where(warange == 0, 0.0, neg_inf)[None, :].expand(B, W).contiguous()
    out_buf = torch.full((B, W, M), eos_id, dtype=torch.int64, device=dev)
    fin_scores = torch.full((B, W), neg_inf, dtype=torch.float32, device=dev)
    fin_out = out_buf.clone()
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    scores, tokens, parent, out_buf, fin_scores, fin_out, done = _beam_select(
        0, lp0[:, None, :].expand(B, W, V), scores, out_buf, fin_scores, fin_out, done,
        noise=noise(), **sel)
    seq_lens = plan_arrays["seq_lens"].repeat_interleave(W)
    s = 1
    while s < M and not bool(done.all()):
        rows = (torch.arange(B, device=dev)[:, None] * W + parent).reshape(-1)
        cache = KVCache(k=cache.k.index_select(1, rows), v=cache.v.index_select(1, rows),
                        kv_mask=cache.kv_mask[rows], length=cache.length[rows])
        logits, cache = model_mod.decode_step(params, cfg, tokens.reshape(-1), seq_lens + (s - 1),
                                              cache, attn_impl=attn_impl)
        lps = warp(torch.log_softmax(logits.float(), dim=-1))
        scores, tokens, parent, out_buf, fin_scores, fin_out, done = _beam_select(
            s, lps.reshape(B, W, V), scores, out_buf, fin_scores, fin_out, done,
            noise=noise(), **sel)
        s += 1
    # Batch items not done bank their live beams, normalized at the full
    # length (HF's max-length criteria), then the best hypothesis wins.
    norm = torch.tensor(float(M), dtype=torch.float32, device=dev) ** length_penalty
    live_norm = torch.where(done[:, None], neg_inf, scores / norm)
    best = torch.argmax(torch.cat([fin_scores, live_norm], dim=1), dim=1)
    return torch.cat([fin_out, out_buf], dim=1)[torch.arange(B, device=dev), best]


def _stream_text(tokenizer, generated, stop_str):
    """(text, stopped): the decoded text, cut at ``stop_str`` if it occurs
    (``find``, not ``endswith``: one step can add the stop string and more)."""
    text = tokenizer.decode(generated, skip_special_tokens=True)
    if stop_str:
        cut = text.find(stop_str)
        if cut >= 0:
            return text[:cut], True
    return text, False


def generate_stream(
    params: dict,
    cfg: VCoderConfig,
    input_ids: Sequence[Sequence[int]],
    images: Optional[torch.Tensor] = None,
    segs: Optional[torch.Tensor] = None,
    depths: Optional[torch.Tensor] = None,
    *,
    tokenizer,
    max_new_tokens: int = 512,
    temperature: float = 0.2,
    top_p: float = 1.0,
    seed: int = 0,
    stop_str: Optional[str] = None,
    is_depth_zero: Optional[Sequence[bool]] = None,
    is_seg_zero: Optional[Sequence[bool]] = None,
    attn_impl: str = "auto",
    lookahead: int = 0,
):
    """Token-streaming generation (batch 1, ``generation.py:589``): yields
    the accumulated text after each decode step, cut at ``stop_str``.
    ``lookahead >= 2`` at temperature 0 streams through prompt-lookup
    speculative decoding instead (several tokens per dispatch)."""
    if lookahead >= 2 and temperature <= 0.0:
        yield from _generate_stream_speculative(
            params, cfg, input_ids, images, segs, depths, tokenizer=tokenizer,
            max_new_tokens=max_new_tokens, lookahead=lookahead, stop_str=stop_str,
            is_depth_zero=is_depth_zero, is_seg_zero=is_seg_zero, attn_impl=attn_impl,
        )
        return
    device, plan, plan_arrays, images, segs, depths = _prepare_inputs(
        params, cfg, input_ids, images, segs, depths, is_depth_zero=is_depth_zero,
        is_seg_zero=is_seg_zero,
    )
    logits, cache = _prefill(
        params, cfg, plan_arrays, images, segs, depths, cache_len=plan.seq_len + max_new_tokens,
        use_vcoder_emb=plan.use_vcoder_emb and cfg.use_vcoder_lm_emb, attn_impl=attn_impl,
    )
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    sample = dict(temperature=float(temperature), top_p=float(top_p))
    tok = sample_token(logits, generator, **sample)
    eos = cfg.text.eos_token_id
    generated = []
    for step in range(max_new_tokens):
        t = int(tok[0])
        if t == eos:
            break
        generated.append(t)
        text, stopped = _stream_text(tokenizer, generated, stop_str)
        yield text
        if stopped or step == max_new_tokens - 1:
            break
        logits, cache = model_mod.decode_step(params, cfg, tok, plan_arrays["seq_lens"] + step,
                                              cache, attn_impl=attn_impl)
        tok = sample_token(logits, generator, **sample)


def _generate_stream_speculative(params, cfg, input_ids, images, segs, depths, *, tokenizer,
                                 max_new_tokens, lookahead, stop_str, is_depth_zero,
                                 is_seg_zero, attn_impl):
    """Streaming over ``speculative.generate_speculative`` (``:702``): a
    worker thread pushes each accepted token through a queue, this generator
    yields the accumulated text and aborts generation at the stop string.
    A failure in the worker is stored and re-raised here, after the tokens
    it delivered, so no failure passes for a complete stream."""
    import queue
    import threading

    from vcoder_tpu_torch.speculative import generate_speculative

    q: "queue.Queue" = queue.Queue()
    abort = threading.Event()
    failure = []

    def cb(b, toks):
        q.put(list(toks))
        return not abort.is_set()

    def worker():
        try:
            generate_speculative(
                params, cfg, input_ids, images, segs, depths, max_new_tokens=max_new_tokens,
                lookahead=lookahead, is_depth_zero=is_depth_zero, is_seg_zero=is_seg_zero,
                attn_impl=attn_impl, on_tokens=cb,
            )
        except BaseException as e:  # re-raised in the consumer
            failure.append(e)
        finally:
            q.put(None)

    t = threading.Thread(target=worker, name="speculative-stream", daemon=True)
    t.start()
    generated: list = []
    try:
        while True:
            toks = q.get()
            if toks is None:
                if failure:
                    raise failure[0]
                break
            generated.extend(toks)
            text, stopped = _stream_text(tokenizer, generated, stop_str)
            yield text
            if stopped:
                break
    finally:
        abort.set()
        t.join()


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
    lookahead: int = 0,
    num_beams: int = 1,
    length_penalty: float = 1.0,
) -> GenerationResult:
    """High-level generate (``generation.py:914``): input_ids carry the
    sentinel ids; the splice plan is built here. Runs on the device of the
    parameters. ``lookahead >= 2`` (greedy, no stopping criteria) decodes
    speculatively; ``num_beams > 1`` runs beam search (beam-sample mode at
    temperature > 0)."""
    if num_beams <= 1 and lookahead >= 2 and temperature <= 0.0 and stopping_criteria is None:
        from vcoder_tpu_torch.speculative import generate_speculative

        seqs, _, _ = generate_speculative(
            params, cfg, input_ids, images, segs, depths, max_new_tokens=max_new_tokens,
            lookahead=lookahead, is_depth_zero=is_depth_zero, is_seg_zero=is_seg_zero,
            attn_impl=attn_impl, pad_to=pad_to,
        )
        # EOS-filled past the generated region: the shared first-EOS scan
        # recovers the same num_generated.
        return _finalize_result(seqs, max_new_tokens, cfg, tokenizer, stopping_criteria)
    device, plan, plan_arrays, images, segs, depths = _prepare_inputs(
        params, cfg, input_ids, images, segs, depths, is_depth_zero=is_depth_zero,
        is_seg_zero=is_seg_zero, pad_to=pad_to,
    )
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    common = dict(
        max_new_tokens=max_new_tokens,
        temperature=float(temperature),
        top_p=float(top_p),
        use_vcoder_emb=plan.use_vcoder_emb and cfg.use_vcoder_lm_emb,
        attn_impl=attn_impl,
    )
    if num_beams > 1:
        seqs = _beam_generate(
            params, cfg, plan_arrays, images, segs, depths, generator, num_beams=num_beams,
            length_penalty=float(length_penalty), eos_id=cfg.text.eos_token_id, **common,
        )
        return _finalize_result(seqs.cpu().numpy(), max_new_tokens, cfg, tokenizer,
                                stopping_criteria)
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
