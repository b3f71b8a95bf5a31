"""Prompt-lookup speculative decoding: the host drafting and the acceptance
rule the paged engine's verify step uses.

``_best_match_np``, ``ngram_draft_np`` and ``draft_from_ids`` are copies of
the numpy functions of ``vcoder_tpu/speculative.py`` (``:108``, ``:123``,
``:147``); keep them in step. :func:`accept_window` is ``:177`` in torch: the
ONE acceptance rule of the port, kept here so the paths never diverge.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


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
