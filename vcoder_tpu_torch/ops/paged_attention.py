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
* :func:`carry_paged_attention_fused` (``:1425``; ``_carry_kernel_fused
  :1263``): the fused append + attend of a decode or verify window, bf16 or
  int8 pools, taken by the decoder when :data:`FUSED_APPEND` is set;
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
scale; p rounded to the value dtype before P @ V. A key that no query column
sees is excluded by selects (its V row and V-scale read as 0), never by a
product with 0: in the fused kernel such slots may be mid-write.

The fused form (``:1233-1421``): ``lengths`` include the window for ACTIVE
rows only; the page loop attends the ``old = length - window * active``
pre-window tokens (every column sees them all), then the window itself runs
as one more step from the ``new_k``/``new_v`` operands with the intra-window
causal mask (fully masked for an inactive row), and the window's K/V (int8:
and their scales) are written to slots ``positions[b] + t`` through the page
table; inactive rows write the scratch page, a lookup past the table's end
writes page 0 (the token writer's rule, below).

No aliasing pass-through: the JAX wrappers return the pools through
``input_output_aliases``; here the pools are read in place and the wrappers
return only ``out``. The page writers write the pools IN PLACE
(``index_copy_`` on flat views) and return them for convenience; no caller
may keep an old reference and expect it unchanged.

Wrappers take the plain version for a tensor on the CPU and launch the
kernel for a tensor on CUDA (bf16 q, head_dim 128, pages a multiple of 8 up
to 256; anything else raises). The counters ``launches_bf16`` (K3: stacked
bf16 windows), ``launches_q8`` (K4: stacked int8, any window),
``launches_k8`` (K8: one-layer pool, one token -- which also carries the
engines' bf16 decode, see :func:`carry_paged_attention`) and
``launches_fused`` (K7: fused append + attend, either pool type) count
kernel launches; ``launches_by_window`` counts the stacked and fused
launches by window. What bounds the kernel and what its design does about it
is in the note at the top of ``csrc/paged_attn.cu``: a call with ``C = group
* window <= 16`` query columns (decode, verify) takes its SPLIT body (a row's
pages split over a cluster of :func:`_split_plan` blocks), a call with more
(chunk windows, fused GQA windows past 16 columns) its TILE body (tensor
cores over 64-key tiles loaded from the page table); :func:`split_of` is
the one place that routes.

:data:`FUSED_APPEND` is read at call time by ``models/llama.py`` (the JAX
package reads its flag when a step is traced); it defaults to False, as
there.

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

import ctypes
from typing import Dict, Optional

import torch

from vcoder_tpu_torch.ops import _kernels

NEG_INF = -1e30

#: Decode steps and verify windows of at most 16 tokens append and attend in
#: one kernel (:func:`carry_paged_attention_fused`); read at call time.
FUSED_APPEND = False

# The kernel's bodies (csrc/paged_attn.cu, its entry point's `body` codes).
# The SPLIT body is built for at most SPLIT_MAX_COLUMNS query columns and
# clusters of at most _MAX_SPLIT blocks; per device and instantiation
# (quant, fused, NC) the blocks one wave holds with clusters of 1 ..
# _MAX_SPLIT, asked of the card once; and the cluster size chosen per
# launch shape. The TILE body takes any call, one block a cluster.
BODY_SPLIT = 1
BODY_TILE = 2
SPLIT_MAX_COLUMNS = 16
_MAX_SPLIT = 8
_CAPACITY: dict = {}
_SPLIT: dict = {}

launches_bf16 = 0
launches_q8 = 0
launches_k8 = 0
launches_fused = 0
launches_by_window: Dict[int, int] = {}


def reset_launches() -> None:
    """Set every launch counter of this module to 0."""
    global launches_bf16, launches_q8, launches_k8, launches_fused
    launches_bf16 = launches_q8 = launches_k8 = launches_fused = 0
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
    ``_online_softmax_page_step`` runs it."""
    B, k, H, D = q.shape
    if k != window:
        raise ValueError(f"q carries {k} window tokens, window={window}")
    n_pages, KH, page, _ = k_pages.shape
    if H % KH:
        raise ValueError(f"{H} query heads over {KH} KV heads")
    dev = q.device
    qt = _columns(q, KH).float()
    C = qt.shape[2]
    lengths = lengths.to(device=dev, dtype=torch.int64)
    table = page_table.to(device=dev, dtype=torch.int64)
    n_live = ((lengths + page - 1) // page).clamp(0, table.shape[1])
    # Column c sees tok <= (length - window) + c % window.
    lim = (lengths - window)[:, None] + (torch.arange(C, device=dev) % window)[None, :]
    carry = _page_loop(qt, k_pages, v_pages, table, n_live, lim, _init_carry(B, KH, C, D, dev),
                       dt=q.dtype, k_scale=k_scale, v_scale=v_scale)
    return _finish(carry, q.dtype, k)


def _key_step(qt, kb, vb, ks, vs, tok, lim, carry, *, dt, scale):
    """One block of keys through the online softmax
    (``_online_softmax_page_step``). qt [B, KH, C, D] f32; kb/vb
    [B, KH, n, D]; ks/vs [B, KH, n] or None; tok [n] token indices; lim
    [B, C]: column c sees tok <= lim. A key no column sees has its V row and
    V-scale replaced by 0."""
    m, lsum, acc = carry
    if ks is not None:
        kb, vb = kb.to(dt), vb.to(dt)
    s = torch.einsum("bkcd,bkpd->bkcp", qt, kb.float()) * scale
    if ks is not None:
        s = s * ks[:, :, None, :]
    mask = (tok[None, None, :] <= lim[:, :, None])[:, None]  # [B, 1, C, n]
    seen = (tok[None, :] <= lim.amax(dim=1, keepdim=True))[:, None]  # [B, 1, n]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
    lsum = alpha * lsum + p.sum(dim=-1, keepdim=True)
    if vs is not None:
        p = p * torch.where(seen, vs, torch.zeros_like(vs))[:, :, None, :]
    v32 = torch.where(seen[..., None], vb.float(), torch.zeros((), device=vb.device))
    pv = torch.einsum("bkcp,bkpd->bkcd", p.to(vb.dtype).float(), v32)
    return m_new, lsum, acc * alpha + pv


def _page_loop(qt, k_pages, v_pages, table, n_live, lim, carry, *, dt, k_scale=None,
               v_scale=None):
    """The key step over each row's live pages of one layer's pool, page by
    page. Pages past a row's live count are fully masked, which leaves the
    carry bit-for-bit unchanged, so the loop runs the batch's largest live
    count for every row."""
    n_pages, KH, page, D = k_pages.shape
    tok0 = torch.arange(page, device=qt.device)
    for j in range(int(n_live.max()) if n_live.numel() else 0):
        pg = table[:, j].clamp(0, n_pages - 1)
        ks = vs = None
        if k_scale is not None:
            ks, vs = k_scale[pg], v_scale[pg]
        carry = _key_step(qt, k_pages[pg], v_pages[pg], ks, vs, j * page + tok0, lim, carry,
                          dt=dt, scale=D**-0.5)
    return carry


def _init_carry(B, KH, C, D, dev):
    return (torch.full((B, KH, C, 1), NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((B, KH, C, 1), dtype=torch.float32, device=dev),
            torch.zeros((B, KH, C, D), dtype=torch.float32, device=dev))


def _finish(carry, dt, k):
    _, lsum, acc = carry
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


def carry_paged_attention_fused_ref(
    q, new_k, new_v, k_pages, v_pages, page_table, lengths, positions, active, layer, *,
    window, k_scale=None, v_scale=None, new_ks=None, new_vs=None,
):
    """Plain version of :func:`carry_paged_attention_fused`: attend the
    pre-window pages, then the window from the operands, then append the
    window to the pools (in place). Returns out [B, k, H, D]."""
    B, k, H, D = q.shape
    if k != window:
        raise ValueError(f"q carries {k} window tokens, window={window}")
    l = int(layer)
    kp, vp = k_pages[l], v_pages[l]
    n_pages, KH, page, _ = kp.shape
    dev, dt = q.device, q.dtype
    quant = k_scale is not None
    act = active.to(dev).bool()
    lengths = lengths.to(device=dev, dtype=torch.int64)
    table = page_table.to(device=dev, dtype=torch.int64)
    old = lengths - window * act.long()
    qt = _columns(q, KH).float()
    C = qt.shape[2]
    carry = _init_carry(B, KH, C, D, dev)
    # Every column sees all pre-window tokens: tok < old.
    n_read = ((old + page - 1) // page).clamp(0, table.shape[1])
    carry = _page_loop(qt, kp, vp, table, n_read, (old - 1)[:, None].expand(B, C), carry,
                       dt=dt, k_scale=k_scale[l] if quant else None,
                       v_scale=v_scale[l] if quant else None)
    # The window as one more key block, causal within it; none for an
    # inactive row.
    col_t = (torch.arange(C, device=dev) % window)[None, :]
    lim_w = torch.where(act[:, None], col_t, torch.full_like(col_t, -1))
    nks = new_ks.transpose(1, 2).float() if quant else None
    nvs = new_vs.transpose(1, 2).float() if quant else None
    carry = _key_step(qt, new_k.transpose(1, 2).to(dt), new_v.transpose(1, 2).to(dt), nks, nvs,
                      torch.arange(window, device=dev), lim_w, carry, dt=dt, scale=D**-0.5)
    out = _finish(carry, dt, k)
    pos2d = positions.to(dev).long()[:, None] + torch.arange(window, device=dev)[None, :]
    append_tokens_layer(k_pages, l, new_k, pos2d, page_table, act)
    append_tokens_layer(v_pages, l, new_v, pos2d, page_table, act)
    if quant:
        append_token_scales_layer(k_scale, l, new_ks, pos2d, page_table, act)
        append_token_scales_layer(v_scale, l, new_vs, pos2d, page_table, act)
    return out


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


def body_of(C: int) -> int:
    """The body of a call with ``C = group * window`` query columns: SPLIT
    up to :data:`SPLIT_MAX_COLUMNS` (decode and verify), TILE past it
    (chunk windows, fused GQA windows). The routing rule, in one place."""
    return BODY_SPLIT if C <= SPLIT_MAX_COLUMNS else BODY_TILE


def _nc(C: int) -> int:
    """The SPLIT body's column count for C columns (its instantiation)."""
    return next(n for n in (1, 2, 4, 8, 16) if C <= n)


def _split_plan(B: int, KH: int, C: int, max_live_pages: int, capacity) -> int:
    """Blocks of a cluster splitting each row's pages: the most (up to
    ``_MAX_SPLIT``, and no more than ``max_live_pages``, the table's width)
    whose grid of ``B * KH`` clusters still fits one wave, ``capacity[s - 1]``
    blocks for clusters of ``s``; 1 when even that does not fit. A second
    wave would double the time of its blocks. ``C`` only names the
    instantiation ``capacity`` was asked for."""
    del C
    best = 1
    for s in range(2, min(_MAX_SPLIT, max_live_pages) + 1):
        if B * KH * s <= capacity[s - 1]:
            best = s
    return best


def _capacity(idx: int, quant: bool, fused: bool, C: int) -> tuple:
    """The SPLIT body's one-wave capacity on CUDA device ``idx`` for the
    instantiation of (quant, fused, C), clusters of 1 .. ``_MAX_SPLIT``
    blocks, asked of the card once."""
    key = (idx, bool(quant), bool(fused), _nc(C))
    if key not in _CAPACITY:
        blocks = (ctypes.c_int * _MAX_SPLIT)()
        with torch.cuda.device(idx):
            err = _kernels.lib("paged_attn").paged_attn_capacity(
                int(quant), int(fused), int(C), ctypes.addressof(blocks))
        _kernels.check(err, "paged_attn_capacity")
        _CAPACITY[key] = tuple(blocks)
    return _CAPACITY[key]


def split_of(q: torch.Tensor, KH: int, p_max: int, *, quant: bool, fused: bool) -> tuple:
    """The kernel's ``(body, cluster)`` arguments for a launch on ``q`` [B, k,
    H, D] over ``KH`` KV heads and a table of width ``p_max``: the body of
    :func:`body_of`, and for the SPLIT body its cluster size (:func:`_split_plan`
    under the card's capacity), 1 for the TILE body. The one place that
    routes a call between the bodies; the card is asked only for the SPLIT
    body's capacity."""
    B, k, H, _ = q.shape
    C = (H // KH) * k
    if body_of(C) == BODY_TILE:
        return BODY_TILE, 1
    idx = q.device.index if q.device.index is not None else torch.cuda.current_device()
    key = (idx, B, KH, C, p_max, bool(quant), bool(fused))
    if key not in _SPLIT:
        _SPLIT[key] = _split_plan(B, KH, C, p_max, _capacity(idx, quant, fused, C))
    return BODY_SPLIT, _SPLIT[key]


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
    fused: Optional[tuple] = None,
) -> torch.Tensor:
    """Launch ``paged_attn.cu`` on CUDA tensors (no counting). q may be a
    strided view with its head dim contiguous. ``fused``: the window's
    ``(new_k, new_v, new_ks, new_vs, positions, active)`` -- the kernel then
    appends them to the pools (written in place) as it attends."""
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
    if any(x.data_ptr() % 16 for _, x in pools):
        raise ValueError("paged_attn: the pools must be 16-byte aligned (bulk copies)")
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if table.ndim != 2 or table.shape[0] != B or lens.shape != (B,):
        raise ValueError("paged_attn: page_table must be [B, P_max] and lengths [B]")
    ptrs = [None] * 6
    if fused is not None:
        nk, nv, nks, nvs, positions, active = fused
        for name, x, shape, want in (
            ("new_k", nk, (B, k, KH, D), pool_dtype), ("new_v", nv, (B, k, KH, D), pool_dtype),
        ) + ((("new_ks", nks, (B, k, KH), torch.float32),
              ("new_vs", nvs, (B, k, KH), torch.float32)) if quant else ()):
            if (x.device != q.device or x.dtype != want or tuple(x.shape) != shape
                    or not x.is_contiguous() or x.data_ptr() % (4 if "s" in name[4:] else 16)):
                raise ValueError(
                    f"paged_attn: {name} must be a contiguous, aligned {want} {shape} "
                    f"on {q.device}")
        pos = positions.to(device=q.device, dtype=torch.int32).contiguous()
        act = active.to(device=q.device, dtype=torch.int32).contiguous()
        if pos.shape != (B,) or act.shape != (B,):
            raise ValueError("paged_attn: positions and active must be [B]")
        ptrs = [nk.data_ptr(), nv.data_ptr(), nks.data_ptr() if quant else None,
                nvs.data_ptr() if quant else None, pos.data_ptr(), act.data_ptr()]
    out = torch.empty((B, k, H, D), dtype=q.dtype, device=q.device)
    body, cluster = split_of(q, KH, table.shape[1], quant=quant, fused=fused is not None)
    fn = _kernels.lib("paged_attn").paged_attn
    err = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        table.data_ptr(), lens.data_ptr(), out.data_ptr(), *ptrs,
        B, window, H, KH, n_pages, page, table.shape[1],
        q.stride(0), q.stride(1), q.stride(2),
        float(D**-0.5), int(quant), int(fused is not None), body, cluster,
        _kernels.stream_handle(q.device),
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
    _kernels.forbid_grad("carry_paged_attention_multi", q, k_pages, v_pages)
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
    _kernels.forbid_grad("carry_paged_attention_multi_q8", q, k_scale, v_scale)
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
    _kernels.forbid_grad("paged_attention", q, k_pages, v_pages)
    out = launch_paged_attn(q[:, None], k_pages, v_pages, page_table, lengths, window=1)
    launches_k8 += 1
    return out[:, 0]


def carry_paged_attention_fused(
    q: torch.Tensor,  # [B, k, H, D]
    new_k: torch.Tensor,  # [B, k, KH, D] pool dtype (int8: quantized)
    new_v: torch.Tensor,
    k_pages: torch.Tensor,  # [L, n_pages, KH, page, D] stacked pool
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, P_max]
    lengths: torch.Tensor,  # [B] tokens INCLUDING the window (active rows)
    positions: torch.Tensor,  # [B] position of window token 0
    active: torch.Tensor,  # [B] bool
    layer,
    *,
    window: int,
    k_scale: Optional[torch.Tensor] = None,  # [L, n_pages, KH, page] f32
    v_scale: Optional[torch.Tensor] = None,
    new_ks: Optional[torch.Tensor] = None,  # [B, k, KH] f32
    new_vs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused append + attend over layer ``layer`` (decode at window 1,
    speculative verify at window k): the window's K/V (and scales for int8
    pools) are written into each active row's slots from inside the kernel
    and attended from the operands. Returns out [B, k, H, D]; the pools are
    written in place. No page-size rule (the TPU's ``page_size % 128`` assert
    was a Mosaic rule)."""
    global launches_fused
    quant = k_scale is not None
    if quant and k_pages.dtype != torch.int8:
        raise TypeError(f"int8 pools expected, got {k_pages.dtype}")
    if not _on_cuda(q):
        return carry_paged_attention_fused_ref(
            q, new_k, new_v, k_pages, v_pages, page_table, lengths, positions, active, layer,
            window=window, k_scale=k_scale, v_scale=v_scale, new_ks=new_ks, new_vs=new_vs,
        )
    _kernels.forbid_grad("carry_paged_attention_fused", q, new_k, new_v, new_ks, new_vs)
    l = int(layer)
    out = launch_paged_attn(
        q, k_pages[l], v_pages[l], page_table, lengths, window=window,
        k_scale=k_scale[l] if quant else None, v_scale=v_scale[l] if quant else None,
        fused=(new_k, new_v, new_ks, new_vs, positions, active),
    )
    launches_fused += 1
    _count(window)
    return out


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
