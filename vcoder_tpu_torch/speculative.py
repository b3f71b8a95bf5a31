"""Prompt-lookup speculative decoding (port of ``vcoder_tpu/speculative.py``).

Greedy decoding is deterministic, so a cheap draft-and-verify scheme emits
the same tokens as one-token-at-a-time greedy decoding with fewer decoder
dispatches: draft ``lookahead - 1`` tokens by n-gram lookup in the history
(prompt + generated), verify ``[current, drafts...]`` in ONE decoder
dispatch over the dense cache, accept the longest matching prefix plus the
model's correction token, and trim the cache back to the accepted length.

* :func:`ngram_draft` (``:65``) drafts on the device, so a step
  (:func:`_spec_step`, ``:238``) needs no host sync; the host polls ``done``
  once per ``poll_every`` steps (:func:`generate_speculative`, ``:311``).
* ``_best_match_np``, ``ngram_draft_np`` and ``draft_from_ids`` are copies of
  the numpy twins (``:108``, ``:123``, ``:147``) the serving engines use;
  :func:`build_history` is ``:163``. Keep them in step.
* :func:`accept_window` (``:177``) is THE acceptance rule of the port (this
  module's step and the paged engine's verify) and :func:`trim_cache`
  (``:209``) the one trim rule of the dense cache, kept here so the paths
  never diverge.

Verify windows of at most 16 columns take the plain attention route
(``ops/attention.py``), as in JAX; the prefill runs the flash kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vcoder_tpu_torch.models.llama import KVCache


def _best_match(history: torch.Tensor, hist_len: torch.Tensor, n: int) -> torch.Tensor:
    """Latest start s with history[s:s+n] == the last n tokens and at least
    one continuation token before ``hist_len``: [B] (-1 when none)."""
    B, H = history.shape
    W = H - n
    dev = history.device
    key_idx = (hist_len[:, None] - n + torch.arange(n, device=dev)[None, :]).clamp(0, H - 1)
    key = torch.gather(history, 1, key_idx)  # [B, n]
    m = torch.ones((B, W), dtype=torch.bool, device=dev)
    for j in range(n):
        m &= history[:, j : j + W] == key[:, j : j + 1]
    starts = torch.arange(W, device=dev)[None, :]
    m &= starts + n < hist_len[:, None]
    return torch.where(m, starts, torch.full_like(starts, -1)).amax(dim=1)


def ngram_draft(
    history: torch.Tensor,  # [B, H] (sentinels < 0 never match)
    hist_len: torch.Tensor,  # [B]
    num_draft: int,
) -> torch.Tensor:
    """Propose ``num_draft`` continuation tokens per row on the device: the
    tokens that followed the most recent earlier occurrence of the trailing
    3-gram (else 2-gram); zeros where nothing matches or the continuation
    runs past ``hist_len`` (verification rejects junk drafts)."""
    B, H = history.shape
    best3 = _best_match(history, hist_len, 3)
    best2 = _best_match(history, hist_len, 2)
    cont = torch.where(best3 >= 0, best3 + 3, best2 + 2)
    found = (best3 >= 0) | (best2 >= 0)
    raw = cont[:, None] + torch.arange(num_draft, device=history.device)[None, :]
    draft = torch.gather(history, 1, raw.clamp(0, H - 1))
    # Test the UNCLIPPED index: with a full buffer the clipped one would
    # repeat history[H-1] where the host twin emits zeros.
    ok = found[:, None] & (raw < hist_len[:, None])
    return torch.where(ok, draft, torch.zeros_like(draft))


def _best_match_np(row: np.ndarray, length: int, n: int) -> int:
    """Latest start s with row[s:s+n] == the last n tokens and at least one
    continuation token before ``length`` (-1 when none)."""
    if length < n + 1:
        return -1
    key = row[length - n : length]
    W = length - n
    if W <= 0:
        return -1
    m = np.ones(W, bool)
    for j in range(n):
        m &= row[j : j + W] == key[j]
    idx = np.nonzero(m)[0]
    return int(idx[-1]) if idx.size else -1


def ngram_draft_np(
    history: np.ndarray,  # [B, H] int32
    hist_len: np.ndarray,  # [B]
    num_draft: int,
) -> np.ndarray:
    """Propose ``num_draft`` tokens per row: the tokens that followed the most
    recent earlier occurrence of the trailing 3-gram (else 2-gram); zeros
    where nothing matches (verification rejects junk drafts)."""
    B = history.shape[0]
    out = np.zeros((B, num_draft), np.int32)
    for b in range(B):
        L = int(hist_len[b])
        s = _best_match_np(history[b], L, 3)
        n = 3
        if s < 0:
            s = _best_match_np(history[b], L, 2)
            n = 2
        if s < 0:
            continue
        cont = history[b, s + n : min(s + n + num_draft, L)]
        out[b, : cont.size] = cont
    return out


def draft_from_ids(rows: Sequence[Optional[Sequence[int]]], num_draft: int) -> np.ndarray:
    """Per-row drafts from python token lists (None rows -> zero drafts)."""
    B = len(rows)
    out = np.zeros((B, num_draft), np.int32)
    for b, ids in enumerate(rows):
        if not ids:
            continue
        row = np.asarray(ids, np.int32)
        out[b] = ngram_draft_np(row[None, :], np.asarray([len(ids)]), num_draft)[0]
    return out


def build_history(
    input_ids: Sequence[Sequence[int]], max_new_tokens: int, lookahead: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Host history buffer: prompt ids (sentinels < 0 act as match barriers;
    generated tokens are always >= 0) plus room for the generated tokens."""
    lens = np.asarray([len(r) for r in input_ids], np.int32)
    H = int(lens.max()) + max_new_tokens + lookahead
    hist = np.full((len(input_ids), H), -1, np.int32)
    for b, row in enumerate(input_ids):
        hist[b, : len(row)] = np.asarray(row, np.int32)
    return hist, lens


def accept_window(
    outs: torch.Tensor,  # [B, k] model tokens per window position
    draft: torch.Tensor,  # [B, k-1] proposed drafts
    no_accept: torch.Tensor,  # [B] bool rows whose drafts never count
    inactive: torch.Tensor,  # [B] bool rows that emit 0
    budget: torch.Tensor,  # [B] tokens each row may still emit
    eos_id: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accept the longest prefix of drafts matching ``outs`` plus the model's
    correction token, cap at the first emitted EOS, then at ``budget``;
    ``inactive`` rows emit 0. Returns (emit [B], nxt [B]), ``nxt`` being the
    last emitted token (the next step's input)."""
    B, k = outs.shape
    dev = outs.device
    jpos = torch.arange(k, device=dev)[None, :]
    match = (outs[:, :-1] == draft.to(dev)) & ~no_accept.to(dev)[:, None]
    accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
    emit = accepted + 1
    is_eos = (outs == eos_id) & (jpos < emit[:, None])
    has_eos = is_eos.any(dim=1)
    first_eos = torch.where(is_eos, jpos, torch.full_like(jpos, k)).amin(dim=1)
    emit = torch.where(has_eos, torch.minimum(emit, first_eos + 1), emit)
    emit = torch.where(
        inactive.to(dev), torch.zeros_like(emit), torch.minimum(emit, budget.to(dev).long())
    )
    last = (emit - 1).clamp(0, k - 1)
    nxt = outs[torch.arange(B, device=dev), last]
    return emit, nxt


def trim_cache(cache: KVCache, new_len: torch.Tensor) -> KVCache:
    """Trim rows to the accepted length after a verify dispatch: rejected
    slots stay as garbage, masked out (``kv_mask`` is exactly ``pos <
    length``) and overwritten by the next dispatch. A quantized cache's scale
    tensors ride along."""
    S = cache.k.shape[2]
    pos_s = torch.arange(S, device=new_len.device)[None, :]
    return dataclasses.replace(cache, kv_mask=pos_s < new_len[:, None], length=new_len)


def _spec_step(params, cfg, tok, cache, done, history, hist_len, cursor, out_buf, *,
               lookahead: int, max_new_tokens: int, eos_id: int, attn_impl: str):
    """Draft + one multi-token verify dispatch + accept + state update, all
    on the device (``:238``). ``history`` [B, H + 1] and ``out_buf`` [B,
    max_new_tokens + lookahead + 1] end in one spare column that takes the
    writes JAX drops (``mode="drop"``). The cache is written in place."""
    from vcoder_tpu_torch.models import llama as llama_mod

    B = tok.shape[0]
    k = lookahead
    H = history.shape[1] - 1
    dev = tok.device
    jpos = torch.arange(k, device=dev)[None, :]

    draft = ngram_draft(history[:, :H], hist_len, k - 1)
    positions0 = cache.length  # == prompt_len + generated - 1, per row
    ids = torch.cat([tok[:, None], draft], dim=1)
    embeds = llama_mod.embed_tokens(params["lm"], ids)
    hidden, cache = llama_mod.llama_forward(
        params["lm"], cfg.text, embeds,
        attn_mask=torch.ones((B, k), dtype=torch.bool, device=dev),
        position_ids=positions0[:, None] + jpos, cache=cache, write_offset=positions0,
        attn_impl=attn_impl,
    )
    pred = torch.argmax(llama_mod.lm_head(params["lm"], hidden), dim=-1)  # [B, k]

    emit, nxt = accept_window(pred, draft, torch.zeros_like(done), done,
                              (max_new_tokens - cursor).clamp_min(0), eos_id)
    live = jpos < emit[:, None]
    spare = out_buf.shape[1] - 1
    out_buf.scatter_(1, torch.where(live, cursor[:, None] + jpos, spare), pred)
    hidx = hist_len[:, None] + jpos
    history.scatter_(1, torch.where(live & (hidx < H), hidx, H), pred)
    hist_len = torch.clamp(hist_len + emit, max=H)
    cache = trim_cache(cache, positions0 + emit)
    cursor = cursor + emit
    done = done | ((emit > 0) & (nxt == eos_id)) | (cursor >= max_new_tokens)
    nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
    return nxt, cache, done, history, hist_len, cursor, out_buf


def generate_speculative(
    params: dict,
    cfg,
    input_ids: Sequence[Sequence[int]],
    images=None,
    segs=None,
    depths=None,
    *,
    max_new_tokens: int = 512,
    lookahead: int = 8,
    is_depth_zero: Optional[Sequence[bool]] = None,
    is_seg_zero: Optional[Sequence[bool]] = None,
    attn_impl: str = "auto",
    pad_to: Optional[int] = None,
    poll_every: int = 8,
    on_tokens=None,
):
    """Greedy generation via prompt-lookup speculative decoding (``:311``):
    the tokens of greedy ``generation.generate`` from fewer decoder
    dispatches. Returns (sequences [B, max_new_tokens] EOS-filled,
    num_generated [B], dispatches).

    ``poll_every`` steps are dispatched between ``done`` polls (overshoot
    steps on finished rows emit nothing). ``on_tokens(b, tokens)`` is called
    with each row's newly accepted ids after every step (it sets
    ``poll_every`` to 1); returning ``False`` aborts, and no callback follows
    a ``False``."""
    from vcoder_tpu_torch.generation import _prefill, _prepare_inputs

    if lookahead < 2:
        raise ValueError("lookahead must be >= 2 (1 current + >=1 draft)")
    if on_tokens is not None:
        poll_every = 1
    dev, plan, plan_arrays, images, segs, depths = _prepare_inputs(
        params, cfg, input_ids, images, segs, depths, is_depth_zero=is_depth_zero,
        is_seg_zero=is_seg_zero, pad_to=pad_to,
    )
    B, T = plan.safe_ids.shape
    k = lookahead
    eos = cfg.text.eos_token_id
    logits, cache = _prefill(
        params, cfg, plan_arrays, images, segs, depths, cache_len=T + max_new_tokens + k,
        use_vcoder_emb=plan.use_vcoder_emb and cfg.use_vcoder_lm_emb, attn_impl=attn_impl,
    )
    first_tok = torch.argmax(logits, dim=-1)

    history_np, hist_len_np = build_history(input_ids, max_new_tokens, k)
    H = history_np.shape[1]
    rows = torch.arange(B, device=dev)
    history = torch.full((B, H + 1), -1, dtype=torch.int64, device=dev)
    history[:, :H] = torch.from_numpy(history_np).to(dev)
    hist_len = torch.from_numpy(hist_len_np).to(dev, torch.int64)
    done = first_tok == eos
    history[rows, torch.where((hist_len < H) & ~done, hist_len, H)] = first_tok
    hist_len = torch.where(done, hist_len, torch.clamp(hist_len + 1, max=H))
    out_buf = torch.full((B, max_new_tokens + k + 1), eos, dtype=torch.int64, device=dev)
    out_buf[:, 0] = first_tok
    cursor = torch.ones((B,), dtype=torch.int64, device=dev)
    done = done | (cursor >= max_new_tokens)
    tok = first_tok

    streamed = np.zeros((B,), np.int64)  # tokens already sent to on_tokens
    aborted = False
    if on_tokens is not None:
        first_h = first_tok.cpu().numpy()
        for b in range(B):
            if int(first_h[b]) != eos:
                if on_tokens(b, [int(first_h[b])]) is False:
                    aborted = True  # no further callbacks, to any row
                    break
                streamed[b] = 1

    iters = 0
    # Every live step emits >= 1 token, so this bound is never the exit.
    while iters < max_new_tokens and not aborted:
        for _ in range(poll_every):
            tok, cache, done, history, hist_len, cursor, out_buf = _spec_step(
                params, cfg, tok, cache, done, history, hist_len, cursor, out_buf,
                lookahead=k, max_new_tokens=max_new_tokens, eos_id=eos, attn_impl=attn_impl,
            )
            iters += 1
        done_h = done.cpu().numpy()
        if on_tokens is not None:
            cur_h = cursor.cpu().numpy()
            buf_h = out_buf.cpu().numpy()
            for b in range(B):
                if aborted:
                    break
                n = int(cur_h[b])
                while streamed[b] < n and buf_h[b, streamed[b]] != eos:
                    if on_tokens(b, [int(buf_h[b, streamed[b]])]) is False:
                        aborted = True
                        break
                    streamed[b] += 1
        if done_h.all():
            break

    seqs = out_buf[:, :max_new_tokens].cpu().numpy()
    num_gen = cursor.cpu().numpy().astype(np.int64)
    # A trailing EOS counts as generated only where it is the genuine stop
    # token (sequential greedy counts the tokens before EOS).
    for b in range(B):
        row_eos = np.nonzero(seqs[b] == eos)[0]
        if row_eos.size:
            num_gen[b] = min(num_gen[b], int(row_eos[0]))
    return seqs, num_gen, iters
