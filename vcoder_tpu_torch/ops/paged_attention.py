"""Paged attention over KV page pools: the CUDA kernel ``csrc/paged_attn.cu``,
its plain PyTorch version, and the page writers.

Port of the single-device parts of ``vcoder_tpu/ops/paged_attention.py``:

* :func:`carry_paged_attention_multi` (``:374``; TPU kernel
  ``_carry_kernel_multi:297``) and :func:`carry_paged_attention` (``:208``,
  window 1) over a STACKED bf16 pool ``[L, n_pages, KH, page, D]``;
* :func:`carry_paged_attention_multi_q8` (``:765``; ``_carry_kernel_multi_q8
  :664``) and :func:`carry_paged_attention_q8` (``:937``) over int8 pools with
  f32 per-token-per-head scales ``[L, n_pages, KH, page]``;
* :func:`paged_attention` (``:132``; ``_paged_kernel:55``) over an UNSTACKED
  pool ``[n_pages, KH, page, D]``, which the CUDA kernel serves as a one-layer
  pool at window 1;
* the page writers ``append_token_layer:1090``, ``append_scale_layer:1127``,
  ``append_tokens_layer:477``, ``append_token_scales_layer:879``,
  ``append_pages_layer:536``, ``append_page_scales_layer:578`` and
  ``write_prompt_pages:1219``.

Function: window token t of a row sits at position ``length - window + t``
(``lengths`` INCLUDE the window) and attends the row's pages causally up to
it; query column ``c = g * window + t`` serves head ``kh * group + g`` (GQA);
page ids come from the page table, clipped to the pool; a row of length 0
gives zeros. The math is ``_online_softmax_page_step:248`` with
``FOLD_SCALES=True``: f32 logits scaled by ``D**-0.5``, then by the key's
scale; online softmax page by page; the row sum taken before the value's
scale; p rounded to the value dtype before P @ V.

No aliasing pass-through: the JAX wrappers return the pools through
``input_output_aliases``; here the pools are read in place and the wrappers
return only ``out``. The page writers write the pools IN PLACE
(``index_copy_`` on flat views) and return them for convenience; no caller
may keep an old reference and expect it unchanged.

Wrappers take the plain version for a tensor on the CPU and launch the
kernel for a tensor on CUDA (bf16 q, head_dim 128, pages a multiple of 8 up
to 256; anything else raises). The counters ``launches_bf16`` (K3: stacked
bf16 windows), ``launches_q8`` (K4: stacked int8, any window) and
``launches_k8`` (K8: one-layer pool, one token -- which also carries the
engines' bf16 decode, see :func:`carry_paged_attention`) count kernel
launches; ``launches_by_window`` counts the stacked launches by window. What
bounds the kernel and what its design does about it is in the note at the
top of ``csrc/paged_attn.cu``.

Out-of-range indices follow JAX, which gathers with a fill value and drops
out-of-range scatters where PyTorch would fault:

* a table lookup past ``P_max`` (a window crossing the table's end) reads
  JAX's int32 fill value ``INT32_MIN``; in the token writers' int32
  flat-index arithmetic ``INT32_MIN * KH * page`` wraps to 0 (``KH * page``
  is even), so the write lands on page 0 of the layer -- the sentinel page
  -- and the port writes there too;
* the page-granular writer's index ``l * n_pages + INT32_MIN`` is out of
  range, so JAX drops the block; the port parks it on the scratch page (the
  last page) instead, which costs no host sync. Every other page matches
  JAX; the scratch page is garbage by convention (inactive rows park there
  in both packages).

Duplicate scatter targets (several inactive rows writing the scratch page in
one ``index_copy_``) land in no defined order; that is harmless only because
the scratch page is never read as valid.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from vcoder_tpu_torch.ops import _kernels

NEG_INF = -1e30

launches_bf16 = 0
launches_q8 = 0
launches_k8 = 0
launches_by_window: Dict[int, int] = {}


def reset_launches() -> None:
    """Set every launch counter of this module to 0."""
    global launches_bf16, launches_q8, launches_k8
    launches_bf16 = launches_q8 = launches_k8 = 0
    launches_by_window.clear()


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _columns(q: torch.Tensor, KH: int) -> torch.Tensor:
    """[B, k, H, D] -> [B, KH, group*k, D]: query column c = g*k + t."""
    B, k, H, D = q.shape
    group = H // KH
    return q.reshape(B, k, KH, group, D).permute(0, 2, 3, 1, 4).reshape(B, KH, group * k, D)


def _uncolumns(o: torch.Tensor, k: int) -> torch.Tensor:
    """[B, KH, group*k, D] -> [B, k, H, D]."""
    B, KH, C, D = o.shape
    group = C // k
    return o.reshape(B, KH, group, k, D).permute(0, 3, 1, 2, 4).reshape(B, k, KH * group, D)


def paged_attention_multi_ref(
    q: torch.Tensor,  # [B, k, H, D]
    k_pages: torch.Tensor,  # ONE layer [n_pages, KH, page, D]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, P_max]
    lengths: torch.Tensor,  # [B] tokens including the window
    *,
    window: int,
    k_scale: Optional[torch.Tensor] = None,  # [n_pages, KH, page] f32
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function over one layer's pool, page by page as
    ``_online_softmax_page_step`` runs it. Pages past a row's live count are
    fully masked, which leaves the carry bit-for-bit unchanged, so the loop
    runs the batch's largest live count for every row."""
    B, k, H, D = q.shape
    if k != window:
        raise ValueError(f"q carries {k} window tokens, window={window}")
    n_pages, KH, page, _ = k_pages.shape
    if H % KH:
        raise ValueError(f"{H} query heads over {KH} KV heads")
    dt = q.dtype
    dev = q.device
    qt = _columns(q, KH).float()
    C = qt.shape[2]
    scale = D**-0.5
    lengths = lengths.to(device=dev, dtype=torch.int64)
    table = page_table.to(device=dev, dtype=torch.int64)
    P_max = table.shape[1]
    n_live = ((lengths + page - 1) // page).clamp(0, P_max)
    n_iter = int(n_live.max()) if B else 0
    # Column c sees tok <= (length - window) + c % window.
    lim = (lengths - window)[:, None] + (torch.arange(C, device=dev) % window)[None, :]
    m = torch.full((B, KH, C, 1), NEG_INF, dtype=torch.float32, device=dev)
    lsum = torch.zeros((B, KH, C, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KH, C, D), dtype=torch.float32, device=dev)
    tok0 = torch.arange(page, device=dev)
    for j in range(n_iter):
        pg = table[:, j].clamp(0, n_pages - 1)
        kb, vb = k_pages[pg], v_pages[pg]  # [B, KH, page, D]
        if k_scale is not None:
            kb, vb = kb.to(dt), vb.to(dt)
        s = torch.einsum("bkcd,bkpd->bkcp", qt, kb.float()) * scale
        if k_scale is not None:
            s = s * k_scale[pg][:, :, None, :]
        mask = ((j * page + tok0)[None, None, :] <= lim[:, :, None])[:, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
        lsum = alpha * lsum + p.sum(dim=-1, keepdim=True)
        if v_scale is not None:
            p = p * v_scale[pg][:, :, None, :]
        pv = torch.einsum("bkcp,bkpd->bkcd", p.to(vb.dtype).float(), vb.float())
        acc = acc * alpha + pv
        m = m_new
    l_safe = torch.where(lsum == 0.0, torch.ones_like(lsum), lsum)
    return _uncolumns((acc / l_safe).to(dt), k)


def carry_paged_attention_multi_ref(q, k_pages, v_pages, page_table, lengths, layer, *, window):
    """Plain version of :func:`carry_paged_attention_multi` (stacked pool)."""
    l = int(layer)
    return paged_attention_multi_ref(
        q, k_pages[l], v_pages[l], page_table, lengths, window=window
    )


def carry_paged_attention_multi_q8_ref(
    q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, layer, *, window
):
    """Plain version of :func:`carry_paged_attention_multi_q8`."""
    l = int(layer)
    return paged_attention_multi_ref(
        q, k_pages[l], v_pages[l], page_table, lengths, window=window,
        k_scale=k_scale[l], v_scale=v_scale[l],
    )


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths):
    """Plain version of :func:`paged_attention` (unstacked pool, one token)."""
    return paged_attention_multi_ref(
        q[:, None], k_pages, v_pages, page_table, lengths, window=1
    )[:, 0]


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


def launch_paged_attn(
    q: torch.Tensor,
    k_pages: torch.Tensor,  # ONE layer [n_pages, KH, page, 128]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch ``paged_attn.cu`` on CUDA tensors (no counting). q may be a
    strided view with its head dim contiguous."""
    B, k, H, D = q.shape
    n_pages, KH, page, Dk = k_pages.shape
    quant = k_scale is not None
    if D != 128 or Dk != 128:
        raise ValueError(f"paged_attn: head_dim {D} is not 128")
    if k != window or H % KH:
        raise ValueError(f"paged_attn: bad shapes q{tuple(q.shape)} pages{tuple(k_pages.shape)}")
    if page % 8 or page > 256:
        raise ValueError(f"paged_attn: page size {page} is not a multiple of 8 up to 256")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged_attn: q must be bfloat16, got {q.dtype}")
    if q.stride(-1) != 1 or any(s % 8 for s in q.stride()[:-1]) or q.data_ptr() % 16:
        raise ValueError("paged_attn: q must be head-dim contiguous, strides multiples of 8")
    pool_dtype = torch.int8 if quant else torch.bfloat16
    pools = [("k_pages", k_pages), ("v_pages", v_pages)]
    if quant:
        pools += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, x in pools:
        want = torch.float32 if "scale" in name else pool_dtype
        if x.device != q.device or x.dtype != want or not x.is_contiguous():
            raise ValueError(f"paged_attn: {name} must be contiguous {want} on {q.device}")
    if v_pages.shape != k_pages.shape or (quant and k_scale.shape != k_pages.shape[:3]):
        raise ValueError("paged_attn: pool shapes disagree")
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if table.ndim != 2 or table.shape[0] != B or lens.shape != (B,):
        raise ValueError("paged_attn: page_table must be [B, P_max] and lengths [B]")
    out = torch.empty((B, k, H, D), dtype=q.dtype, device=q.device)
    fn = _kernels.lib("paged_attn").paged_attn
    err = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        table.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, window, H, KH, n_pages, page, table.shape[1],
        q.stride(0), q.stride(1), q.stride(2),
        float(D**-0.5), int(quant), _kernels.stream_handle(q.device),
    )
    _kernels.check(err, "paged_attn")
    return out


def _on_cuda(q: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for CUDA; else raise."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"paged attention: unsupported device {q.device}")
    return True


def _count(window: int) -> None:
    launches_by_window[window] = launches_by_window.get(window, 0) + 1


# ---------------------------------------------------------------------------
# Public wrappers (the JAX signatures; they return only ``out``)
# ---------------------------------------------------------------------------


def carry_paged_attention_multi(
    q: torch.Tensor,  # [B, k, H, D] the k window tokens per row
    k_pages: torch.Tensor,  # [L, n_pages, KH, page, D] stacked pool
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, P_max] int32
    lengths: torch.Tensor,  # [B] tokens INCLUDING the window
    layer,
    *,
    window: int,
) -> torch.Tensor:
    """Window-causal attention over layer ``layer`` of a stacked bf16 pool
    (decode at window 1, speculative verify, chunk prefill). Returns out
    [B, k, H, D]; the pools are read in place."""
    global launches_bf16
    if not _on_cuda(q):
        return carry_paged_attention_multi_ref(
            q, k_pages, v_pages, page_table, lengths, layer, window=window
        )
    l = int(layer)
    out = launch_paged_attn(q, k_pages[l], v_pages[l], page_table, lengths, window=window)
    launches_bf16 += 1
    _count(window)
    return out


def carry_paged_attention(q, k_pages, v_pages, page_table, lengths, layer):
    """Single-token decode (q [B, H, D]) over layer ``layer`` of a stacked
    pool. JAX runs it as :func:`carry_paged_attention_multi` at window 1;
    one layer of the pool is an unstacked pool, so the port runs it through
    :func:`paged_attention` (the same function, and the same CUDA kernel).
    Returns out [B, H, D]."""
    l = int(layer)
    return paged_attention(q, k_pages[l], v_pages[l], page_table, lengths)


def carry_paged_attention_multi_q8(
    q: torch.Tensor,  # [B, k, H, D]
    k_pages: torch.Tensor,  # int8 [L, n_pages, KH, page, D]
    v_pages: torch.Tensor,
    k_scale: torch.Tensor,  # [L, n_pages, KH, page] f32
    v_scale: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,  # [B] tokens INCLUDING the window
    layer,
    *,
    window: int,
) -> torch.Tensor:
    """:func:`carry_paged_attention_multi` over int8 pools with per-token
    scales folded into the logits and the probabilities. No page-size rule:
    the TPU's ``page_size % 128`` assert was a Mosaic tiling rule."""
    global launches_q8
    if k_pages.dtype != torch.int8:
        raise TypeError(f"int8 pools expected, got {k_pages.dtype}")
    if not _on_cuda(q):
        return carry_paged_attention_multi_q8_ref(
            q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, layer,
            window=window,
        )
    l = int(layer)
    out = launch_paged_attn(
        q, k_pages[l], v_pages[l], page_table, lengths, window=window,
        k_scale=k_scale[l], v_scale=v_scale[l],
    )
    launches_q8 += 1
    _count(window)
    return out


def carry_paged_attention_q8(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, layer):
    """Single-token int8 decode: :func:`carry_paged_attention_multi_q8` at
    window 1. Returns out [B, H, D]."""
    return carry_paged_attention_multi_q8(
        q[:, None], k_pages, v_pages, k_scale, v_scale, page_table, lengths,
        layer, window=1,
    )[:, 0]


def paged_attention(
    q: torch.Tensor,  # [B, H, D]
    k_pages: torch.Tensor,  # [n_pages, KH, page, D] unstacked pool
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, P_max]
    lengths: torch.Tensor,  # [B]
) -> torch.Tensor:
    """Single-token decode over an unstacked pool (the TPU's
    ``_paged_kernel``); the CUDA kernel runs it as a one-layer pool at
    window 1."""
    global launches_k8
    if not _on_cuda(q):
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths)
    out = launch_paged_attn(q[:, None], k_pages, v_pages, page_table, lengths, window=1)
    launches_k8 += 1
    return out[:, 0]


# ---------------------------------------------------------------------------
# Page writers (in place)
# ---------------------------------------------------------------------------


def lookup_pages(page_table: torch.Tensor, idx: torch.Tensor):
    """``page_table[b, idx[b, j]]`` for idx >= 0 -> (page ids int64, valid),
    where ``valid`` is False past the table's end (JAX's fill)."""
    P_max = page_table.shape[1]
    ids = torch.gather(page_table.long(), 1, idx.clamp(0, P_max - 1))
    return ids, idx < P_max


def append_token_layer(
    pages_all: torch.Tensor,  # [L, n_pages, KH, page, D]
    l: int,
    token_kv: torch.Tensor,  # [B, KH, D]
    page_ids: torch.Tensor,  # [B] pages in [0, n_pages)
    offsets: torch.Tensor,  # [B]
    active: torch.Tensor,  # [B] bool
) -> torch.Tensor:
    """Write one decode token per row into layer ``l``; inactive rows write
    the scratch page (the last page)."""
    L, n_pages, KH, page, D = pages_all.shape
    dev = pages_all.device
    safe = torch.where(active.to(dev), page_ids.to(dev).long(), n_pages - 1)
    flat_idx = ((l * n_pages + safe)[:, None] * KH + torch.arange(KH, device=dev)[None, :]) * page + offsets.to(dev).long()[:, None]
    pages_all.view(-1, D).index_copy_(
        0, flat_idx.reshape(-1), token_kv.reshape(-1, D).to(pages_all.dtype)
    )
    return pages_all


def append_scale_layer(scales_all, l, token_scale, page_ids, offsets, active):
    """:func:`append_token_layer` for the scale pool [L, n_pages, KH, page]
    (token_scale [B, KH] or [B, KH, 1])."""
    KH = scales_all.shape[2]
    append_token_layer(
        scales_all.unsqueeze(-1), l, token_scale.reshape(-1, KH, 1), page_ids, offsets, active
    )
    return scales_all


def append_tokens_layer(
    pages_all: torch.Tensor,  # [L, n_pages, KH, page, D]
    l: int,
    token_kv: torch.Tensor,  # [B, k, KH, D]
    positions: torch.Tensor,  # [B, k] absolute positions
    page_table: torch.Tensor,  # [B, P_max]
    active: torch.Tensor,  # [B] bool
) -> torch.Tensor:
    """Write a window's K or V (it may straddle a page boundary: each token
    looks its page up in the table). Inactive rows write the scratch page; a
    lookup past the table's end writes page 0, as JAX's wraps (module note)."""
    L, n_pages, KH, page, D = pages_all.shape
    dev = pages_all.device
    pos = positions.to(dev).long()
    ids, valid = lookup_pages(page_table.to(dev), pos // page)
    ids = torch.where(valid, ids, 0)
    safe = torch.where(active.to(dev)[:, None], ids, n_pages - 1)
    flat_idx = (
        (l * n_pages + safe)[:, :, None] * KH + torch.arange(KH, device=dev)[None, None, :]
    ) * page + (pos % page)[:, :, None]  # [B, k, KH]
    pages_all.view(-1, D).index_copy_(
        0, flat_idx.reshape(-1), token_kv.reshape(-1, D).to(pages_all.dtype)
    )
    return pages_all


def append_token_scales_layer(scales_all, l, token_scales, positions, page_table, active):
    """:func:`append_tokens_layer` for the scale pool (token_scales
    [B, k, KH] or [B, k, KH, 1])."""
    B, k = positions.shape
    KH = scales_all.shape[2]
    append_tokens_layer(
        scales_all.unsqueeze(-1), l, token_scales.reshape(B, k, KH, 1), positions,
        page_table, active,
    )
    return scales_all


def append_pages_layer(
    pages_all: torch.Tensor,  # [L, n_pages, KH, page, D]
    l: int,
    token_kv: torch.Tensor,  # [B, k, KH, D], k % page == 0
    positions: torch.Tensor,  # [B, k]; positions[:, 0] % page == 0
    page_table: torch.Tensor,
    active: torch.Tensor,
) -> torch.Tensor:
    """Page-granular window write for page-ALIGNED chunk windows (the caller
    guarantees the alignment): k // page whole pages per row in one
    ``index_copy_`` over ``[L * n_pages, KH * page, D]``. Overhang positions
    land on the table's sentinel entries like the token writer; inactive
    rows write the scratch page; a lookup past the table's end parks on the
    scratch page (module note)."""
    L, n_pages, KH, page, D = pages_all.shape
    B, k = positions.shape
    npg = k // page
    dev = pages_all.device
    pos = positions.to(dev).long()
    ids, valid = lookup_pages(page_table.to(dev), pos[:, ::page] // page)  # [B, npg]
    act = active.to(dev)[:, None]
    safe = torch.where(act & valid, ids, n_pages - 1)
    blocks = (
        token_kv.reshape(B, npg, page, KH, D).transpose(2, 3).reshape(B * npg, KH * page, D)
    )
    pages_all.view(L * n_pages, KH * page, D).index_copy_(
        0, (l * n_pages + safe).reshape(-1), blocks.to(pages_all.dtype)
    )
    return pages_all


def append_page_scales_layer(scales_all, l, token_scales, positions, page_table, active):
    """Page-granular :func:`append_token_scales_layer`."""
    B, k = positions.shape
    KH = scales_all.shape[2]
    append_pages_layer(
        scales_all.unsqueeze(-1), l, token_scales.reshape(B, k, KH, 1), positions,
        page_table, active,
    )
    return scales_all


def write_prompt_pages(
    pages: torch.Tensor,  # [n_pages, KH, page, D]
    new_kv: torch.Tensor,  # [T, KH, D], T % page == 0
    page_ids: torch.Tensor,  # [T // page]
) -> torch.Tensor:
    """Write a prompt's K or V into its allocated pages, in place."""
    T, KH, D = new_kv.shape
    page = pages.shape[2]
    chunks = new_kv.reshape(T // page, page, KH, D).transpose(1, 2)
    pages.index_copy_(0, page_ids.to(pages.device).long(), chunks.to(pages.dtype))
    return pages
