"""Paged-KV continuous-batching engine (port of
``vcoder_tpu/serve/paged_engine.py``, single device).

KV lives in page pools ``[L, n_pages, KH, page, HD]`` (bf16, or int8 with f32
per-token-per-head scales ``[L, n_pages, KH, page]`` when ``kv_quant``),
handed out by a host free-list allocator; a request holds exactly
``ceil(context / page)`` pages. Admission runs the dense prefill (the flash
kernel) and scatters its KV into pages, or, with ``chunked_prefill``, runs
lockstep ``[G, kc]`` chunks of the paged verify forward for G concurrent
admissions; decode and prompt-lookup speculative verify run the paged kernel
(``ops/paged_attention.py``). The prefix cache maps matching full prompt pages
into a new request's table. Pool exhaustion defers admission; a row that
cannot get its next page is preempted by recompute.

Pool conventions, kept exactly: the first page is the sentinel that unused
table entries point at, the last page is the scratch target of inactive
rows' writes; neither is ever allocated. Group chunks may overhang a row's
region onto table entries past its pages; those writes land on the sentinel.

Differences from the JAX engine, none visible in greedy tokens:

* The pools are mutated IN PLACE (JAX threads them through donation); no
  code keeps an old reference.
* ``sync_every = N`` runs N single decode steps per ``step()`` with the same
  ``p_max`` and done rules; the adaptive window keeps its rule.
* No jit: the shape-stability paddings stay (sources and tables padded to
  engine-constant caps, group buckets), which keeps slicing and sentinel
  behaviour identical; ``warmup_chunks`` builds the kernels and runs each
  reachable chunk shape once with every row inactive.
* The TPU's ``page_size % 128`` rule for int8 pools was a Mosaic rule and is
  not kept.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from vcoder_tpu_torch.config import VCoderConfig
from vcoder_tpu_torch.generation import sample_token_batch
from vcoder_tpu_torch.models import llama as llama_mod
from vcoder_tpu_torch.models import vcoder as model_mod
from vcoder_tpu_torch.models.llama import KVCache, _kv_quantize
from vcoder_tpu_torch.ops.paged_attention import write_prompt_pages
from vcoder_tpu_torch.serve.engine import DeferAdmission, Request, ServingEngine
from vcoder_tpu_torch.serve.prefix_cache import PrefixIndex, chain_hashes, content_key_ids
from vcoder_tpu_torch.speculative import accept_window


def _dense_prefill(params, cfg: VCoderConfig, plan_arrays, images, segs, depths, *,
                   use_vcoder_emb: bool, attn_impl: str):
    """Dense prefill into a temporary B=1 cache of the bucketed length
    (``:46``). Returns (first-token logits [V], k, v [L, 1, T, KH, HD])."""
    T = plan_arrays["safe_ids"].shape[1]
    emb = params["lm"]["embed_tokens"]
    tmp = KVCache.create(cfg.text, 1, T, dtype=emb.dtype, device=emb.device)
    logits, tmp = model_mod.prefill(
        params, cfg, plan_arrays, images, segs, depths, cache=tmp,
        use_vcoder_emb=use_vcoder_emb, attn_impl=attn_impl,
    )
    return logits[0], tmp.k, tmp.v


def _scatter_pages(k_pages, v_pages, tmp_k, tmp_v, page_ids, *, n_pages_used: int) -> None:
    """Write a prompt's KV into its pages, layer by layer, in place
    (``:81``). Only the first ``n_pages_used * page`` tokens are written."""
    T_used = n_pages_used * k_pages.shape[3]
    for l in range(k_pages.shape[0]):
        write_prompt_pages(k_pages[l], tmp_k[l, 0, :T_used], page_ids)
        write_prompt_pages(v_pages[l], tmp_v[l, 0, :T_used], page_ids)


def _scatter_pages_q8(k_pages, v_pages, k_scale, v_scale, tmp_k, tmp_v, page_ids, *,
                      n_pages_used: int) -> None:
    """int8-pool :func:`_scatter_pages` (``:108``): quantize per token vector
    and write values and scales."""
    T_used = n_pages_used * k_pages.shape[3]
    for l in range(k_pages.shape[0]):
        kq, ks = _kv_quantize(tmp_k[l, 0, :T_used])  # [T, KH, HD], [T, KH, 1]
        vq, vs = _kv_quantize(tmp_v[l, 0, :T_used])
        write_prompt_pages(k_pages[l], kq, page_ids)
        write_prompt_pages(v_pages[l], vq, page_ids)
        write_prompt_pages(k_scale[l].unsqueeze(-1), ks, page_ids)
        write_prompt_pages(v_scale[l].unsqueeze(-1), vs, page_ids)


def _plan_embeds(params, cfg: VCoderConfig, plan_arrays, images, segs, depths, *,
                 use_vcoder_emb: bool, attn_impl: str) -> torch.Tensor:
    """Spliced embedding sequence [1, T_pad, D] of a planned request, the
    embedding half of the prefill (``:153``)."""
    vis_table = None
    if images is not None:
        vis_table = model_mod.encode_vision(params, cfg, images, segs, depths, attn_impl=attn_impl)
    return model_mod.assemble_embeddings(
        params, cfg, plan_arrays["safe_ids"], plan_arrays["is_text"],
        plan_arrays["vis_idx"], vis_table, use_vcoder_emb=use_vcoder_emb,
    )


def _chunk_rows(source: torch.Tensor, starts: torch.Tensor, kc: int) -> torch.Tensor:
    """Row b's ``kc`` entries of ``source`` [G, T, ...] from ``starts[b]``,
    the start clamped to ``[0, T - kc]`` as ``jax.lax.dynamic_slice_in_dim``
    clamps it."""
    T = source.shape[1]
    cols = starts.clamp(0, T - kc)[:, None] + torch.arange(kc, device=starts.device)[None, :]
    return source[torch.arange(source.shape[0], device=starts.device)[:, None], cols.long()]


def _group_chunk(params, cfg: VCoderConfig, source, k_pages, v_pages, k_scale, v_scale,
                 tables, starts, off: int, active, use_vemb: bool, *, kc: int,
                 text_mode: bool) -> torch.Tensor:
    """One batched chunk of region prefill over paged KV (``:204``): each
    row's ``kc`` positions from ``starts + off`` are written into its own
    pages and attend causally to its cached prefix plus its own window.
    Rows past their region ride inactive (writes go to the scratch page); a
    row's last chunk may overhang its region onto sentinel table entries.
    Returns hidden [G, kc, D]; the pools are updated in place."""
    s = starts + off  # [G]
    if text_mode:
        table = (
            params["vcoder_lm_emb"]
            if (use_vemb and "vcoder_lm_emb" in params)
            else params["lm"]["embed_tokens"]
        )
        embeds = table[_chunk_rows(source, s, kc)]
    else:
        embeds = _chunk_rows(source, s, kc)
    positions = s[:, None] + torch.arange(kc, device=s.device)[None, :]
    return llama_mod.llama_paged_verify(
        params["lm"], cfg.text, embeds, positions, k_pages, v_pages, tables, s, active,
        k_scale=k_scale, v_scale=v_scale,
        # Region starts are m*page and off advances by kc: every window is
        # page-aligned whenever kc is a page multiple.
        page_aligned=kc % k_pages.shape[3] == 0,
    )


def _encode_vision_group(params, cfg: VCoderConfig, images, segs, depths, *,
                         attn_impl: str) -> torch.Tensor:
    """Tower-only half of a group's source -> vision tables [G, N_vis, D]
    (``:282``)."""
    return model_mod.encode_vision(params, cfg, images, segs, depths, attn_impl=attn_impl)


def _assemble_group(params, plan_arrays, vis_table, use_vemb: bool) -> torch.Tensor:
    """Splice half of a group's source over (possibly cached) vision tables
    (``:304``)."""
    table = (
        params["vcoder_lm_emb"]
        if (use_vemb and "vcoder_lm_emb" in params)
        else params["lm"]["embed_tokens"]
    )
    text_e = table[plan_arrays["safe_ids"]]
    idx = plan_arrays["vis_idx"][:, :, None].expand(-1, -1, vis_table.shape[-1])
    vis_e = torch.gather(vis_table, 1, idx).to(text_e.dtype)
    return torch.where(plan_arrays["is_text"][:, :, None], text_e, vis_e)


def _hidden_logits_group(params, hidden, idxs) -> torch.Tensor:
    """lm_head at one (clipped) position of every row of a chunk's hidden
    states -> [G, V] (``:335``)."""
    G, kc, _ = hidden.shape
    idxs = idxs.clamp(0, kc - 1)
    h = hidden[torch.arange(G, device=hidden.device), idxs][:, None]
    return llama_mod.lm_head(params["lm"], h)[:, 0]


def _paged_decode_all(params, cfg: VCoderConfig, tokens, k_pages, v_pages, k_scale, v_scale,
                      page_table, lengths, active, temperature, top_p, rng, *,
                      nucleus: bool = False, sampling: bool = True) -> torch.Tensor:
    """One decode step for every slot (``:353``); returns the next tokens
    [B]. Inactive rows write the scratch page; their token is ignored."""
    embeds = llama_mod.embed_tokens(params["lm"], tokens[:, None])
    hidden = llama_mod.llama_paged_decode(
        params["lm"], cfg.text, embeds, lengths, k_pages, v_pages, page_table, lengths,
        active, k_scale=k_scale, v_scale=v_scale,
    )
    logits = llama_mod.lm_head(params["lm"], hidden)[:, 0]
    return sample_token_batch(logits, rng, temperature, top_p, nucleus=nucleus, sampling=sampling)


def _paged_decode_all_n(params, cfg, tokens, k_pages, v_pages, k_scale, v_scale, page_table,
                        lengths, active, temperature, top_p, rng, *, steps: int,
                        nucleus: bool = False, sampling: bool = True):
    """``steps`` single decode steps (``:404``; the JAX package fuses them
    into one device loop). Returns ([steps, B] tokens, last tokens)."""
    act = active.to(lengths.dtype)
    out = []
    for i in range(steps):
        tokens = _paged_decode_all(
            params, cfg, tokens, k_pages, v_pages, k_scale, v_scale, page_table,
            lengths + i * act, active, temperature, top_p, rng,
            nucleus=nucleus, sampling=sampling,
        )
        out.append(tokens)
    return torch.stack(out), tokens


def _paged_spec_decode_all(params, cfg: VCoderConfig, tokens, draft, k_pages, v_pages,
                           k_scale, v_scale, page_table, lengths, active, budget,
                           temperature, top_p, rng, eos_id: int, *, nucleus: bool = False,
                           sampling: bool = True):
    """Speculative verify step over paged KV (``:467``): returns (outs [B, k],
    emit [B], nxt [B]); the host applies ``emit`` to its lengths."""
    k = 1 + draft.shape[1]
    ids = torch.cat([tokens[:, None], draft], dim=1)
    embeds = llama_mod.embed_tokens(params["lm"], ids)
    positions = lengths[:, None] + torch.arange(k, device=lengths.device)[None, :]
    hidden = llama_mod.llama_paged_verify(
        params["lm"], cfg.text, embeds, positions, k_pages, v_pages, page_table, lengths,
        active, k_scale=k_scale, v_scale=v_scale,
    )
    logits = llama_mod.lm_head(params["lm"], hidden)  # [B, k, V]
    outs = torch.argmax(logits, dim=-1)
    # Sampling rows draw their first position and emit exactly 1.
    outs[:, 0] = sample_token_batch(
        logits[:, 0], rng, temperature, top_p, nucleus=nucleus, sampling=sampling
    )
    emit, nxt = accept_window(outs, draft, temperature > 0.0, ~active, budget, eos_id)
    nxt = torch.where(emit > 0, nxt, tokens)
    return outs, emit, nxt


# Pending-prefill groups pad their batch to the nearest bucket (inactive pad
# rows write the scratch page).
_G_BUCKETS = (1, 2, 4, 8)


def _g_bucket(n: int) -> int:
    for b in _G_BUCKETS:
        if n <= b:
            return b
    return _G_BUCKETS[-1]


class _RegionRow:
    """Bookkeeping for one request's resumable paged region prefill: its
    pages, prefix-hit depth, hashes and, once the chunk holding its last
    prompt token has run, its first-token logits."""

    __slots__ = (
        "req", "row_ids", "m", "hashes", "start", "region", "last_idx",
        "logits", "slot", "t0", "done",
    )

    def __init__(self, *, req, row_ids, m, start, region, last_idx):
        self.req = req
        self.row_ids = row_ids
        self.m = m
        self.hashes: List[bytes] = []
        self.start = start
        self.region = region
        self.last_idx = last_idx
        self.logits = None
        self.slot = -1
        self.t0 = 0.0
        self.done = False


class _PrefillGroup:
    """A lockstep batch of pending region prefills: same padded length,
    modality signature, embed route and adapter. `_advance_group` runs ONE
    `[G, kc]` chunk per call; rows whose region ends early ride inactive
    until the group drains."""

    __slots__ = (
        "rows", "params", "source", "text_mode", "use_vemb", "tables",
        "starts", "off", "chunk", "gb", "max_region", "admit",
        "_active_dev", "_active_dirty",
    )

    def __init__(self, *, rows, params, source, text_mode, use_vemb, tables, starts,
                 chunk, admit):
        self.rows: List[_RegionRow] = rows
        self.params = params
        self.source = source  # [Gb, T, D] embeds or [Gb, T] ids (device)
        self.text_mode = text_mode
        self.use_vemb = use_vemb
        self.tables = tables  # [Gb, P] device
        self.starts = starts  # [Gb] device
        self.off = 0
        self.chunk = chunk
        self.gb = int(tables.shape[0])
        self.max_region = max(rp.region for rp in rows)
        self.admit = admit  # finish rows into decode slots as they drain
        self._active_dev = None
        self._active_dirty = True

    @property
    def done(self) -> bool:
        return all(rp.done for rp in self.rows)

    def active_dev(self):
        if self._active_dirty:
            act = np.zeros((self.gb,), bool)
            for i, rp in enumerate(self.rows):
                act[i] = not rp.done
            self._active_dev = torch.as_tensor(act, device=self.tables.device)
            self._active_dirty = False
        return self._active_dev


class PagedServingEngine(ServingEngine):
    """Continuous batching over paged KV storage."""

    def __init__(
        self,
        cfg: VCoderConfig,
        params: dict,
        *,
        max_batch: int = 8,
        max_len: int = 4096,
        page_size: int = 64,
        total_pages: Optional[int] = None,
        attn_impl: str = "auto",
        seed: int = 0,
        mesh=None,
        kv_quant: bool = False,
        speculative: int = 0,
        sync_every: int = 1,
        prefix_cache: bool = False,
        prefix_chunk: int = 128,
        prefix_max_suffix: int = 1024,
        chunked_prefill: int = 0,
        lora_adapters=None,
        eos_id: Optional[int] = None,
        device="cuda",
    ):
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of page_size {page_size}")
        self.page_size = page_size
        super().__init__(
            cfg, params, max_batch=max_batch, max_len=max_len, attn_impl=attn_impl,
            seed=seed, mesh=mesh, speculative=speculative, sync_every=sync_every,
            lora_adapters=lora_adapters, eos_id=eos_id, device=device,
        )
        # Speculative windows overshoot a row's accepted length by up to
        # spec_k rejected tokens, sync windows by up to sync_every-1; the
        # table covers that slack so writes never need a page past p_max.
        self.p_max = -(-(max_len + max(self.spec_k, self.sync_every)) // page_size)
        if total_pages is None:
            # Every slot at max_len plus the sentinel and the scratch page;
            # set lower to oversubscribe (the point of paging).
            total_pages = max_batch * self.p_max + 2
        if total_pages < 3:
            raise ValueError("need the sentinel, the scratch page and one page")
        self.total_pages = total_pages
        L = cfg.text.num_layers
        KH, HD = cfg.text.num_kv_heads, cfg.text.head_dim
        self.kv_quant = kv_quant
        dtype = torch.int8 if kv_quant else params["lm"]["embed_tokens"].dtype
        shape = (L, total_pages, KH, page_size, HD)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        if kv_quant:
            self.k_scale = torch.zeros(shape[:-1], dtype=torch.float32, device=self.device)
            self.v_scale = torch.zeros(shape[:-1], dtype=torch.float32, device=self.device)
        else:
            self.k_scale = self.v_scale = None
        # The first page is the sentinel for unused table entries and the
        # last is the scratch target of inactive-row writes; neither is ever
        # allocated.
        self.free_pages: List[int] = list(range(1, total_pages - 1))
        self.row_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self.lengths = np.zeros((max_batch,), np.int32)
        self._table_dirty = True
        self._table_dev = None
        self.table = np.zeros((max_batch, self.p_max), np.int32)
        # Automatic prefix caching: full prompt pages are published under
        # chained content hashes; later requests map matching prefix pages
        # into their table and only the suffix runs through the model.
        self.prefix_idx: Optional[PrefixIndex] = PrefixIndex() if prefix_cache else None
        # Suffix chunks are page multiples.
        self._chunk = max(prefix_chunk - prefix_chunk % page_size, page_size)
        self.prefix_max_suffix = prefix_max_suffix
        # Chunked prefill: admissions run `chunked_prefill`-token chunks
        # through the paged verify forward, one chunk per engine step while
        # rows decode, so a long prompt never stalls in-flight decodes for
        # more than a chunk.
        self._cp_chunk = (
            max(chunked_prefill - chunked_prefill % page_size, page_size)
            if chunked_prefill else 0
        )
        self._pending_groups: List[_PrefillGroup] = []
        self.preemptions = 0  # requests requeued for recompute
        self.admit_group_sizes: List[int] = []  # size of every admit group formed
        # Deferred first-token writes (slot, token, request); see
        # _finish_admission/_flush_tokens.
        self._tok_writes: List[Tuple[int, int, Request]] = []
        # Vision-table LRU (pixel digest + adapter -> [N_vis, D]).
        self._vis_cache: "OrderedDict" = OrderedDict()
        self._vis_cache_cap = max(16, max_batch)
        # Group sources and tables pad to these engine constants.
        max_chunk = max(self._chunk, self._cp_chunk)
        self._src_cap = self.p_max * page_size + max_chunk
        self._tbl_cap = self.p_max + max_chunk // page_size

    def _device_table(self):
        if self._table_dirty:
            self._table_dev = torch.as_tensor(self.table, device=self.device)
            self._table_dirty = False
        return self._table_dev

    def close(self) -> None:
        """Free the page pools, the device table, the pending groups and the
        vision-table cache, then the base carries. Idempotent; shared
        ``params`` are left untouched."""
        if getattr(self, "_closed", False):
            return
        self._pending_groups = []
        self._vis_cache.clear()
        self.k_pages = self.v_pages = None
        self.k_scale = self.v_scale = None
        self._table_dev = None
        self._table_dirty = True
        super().close()

    def _make_cache(self):
        # No slot cache: KV lives in the page pools.
        return None

    # ---- paged allocation ----

    def _alloc(self, n: int) -> List[int]:
        free = self.free_pages
        if len(free) < n and self.prefix_idx is not None:
            # Cached-but-unreferenced prefix pages are reclaimable: evict
            # LRU-first until the allocation fits.
            free.extend(self.prefix_idx.evict(n - len(free)))
        if len(free) < n:
            raise PoolExhausted(f"page pool exhausted: need {n}, free {len(free)}")
        out = free[:n]
        del free[:n]
        return out

    def _free_row(self, slot: int) -> None:
        idx = self.prefix_idx
        for pid in self.row_pages[slot]:
            if idx is not None and idx.is_registered(pid):
                # Shared/published page: drop this row's reference; the KV
                # stays cached (evictable at zero refs).
                idx.release(pid)
            else:
                self.free_pages.append(pid)
        self.row_pages[slot] = []
        self.lengths[slot] = 0
        self.table[slot, :] = 0
        self._table_dirty = True

    def warmup_chunks(self, vision: bool = True) -> None:
        """Build the kernels and run every reachable lockstep chunk shape
        once -- group buckets up to ``_g_bucket(max_batch)``, text and (with
        ``vision``) vision sources -- with ALL rows inactive: writes park on
        the scratch page and every other page stays bit-unchanged, so this
        is safe on a live engine between steps."""
        if self.device.type == "cuda":
            from vcoder_tpu_torch.ops import _kernels

            _kernels.build()
        buckets = [gb for gb in _G_BUCKETS if gb <= _g_bucket(self.max_batch)]
        shapes = [(gb, self._cp_chunk) for gb in buckets] if self._cp_chunk else []
        if not any(kc == self._chunk for _, kc in shapes):
            # The prefix-cache suffix path always forms singletons.
            shapes.append((1, self._chunk))
        D = self.cfg.text.hidden_size
        dtype = self.params["lm"]["embed_tokens"].dtype
        modes = [True, False] if vision else [True]
        with torch.no_grad():
            for gb, kc in shapes:
                for text_mode in modes:
                    if text_mode:
                        source = torch.zeros((gb, self._src_cap), dtype=torch.int64, device=self.device)
                    else:
                        source = torch.zeros((gb, self._src_cap, D), dtype=dtype, device=self.device)
                    hidden = _group_chunk(
                        self.params, self.cfg, source, self.k_pages, self.v_pages,
                        self.k_scale, self.v_scale,
                        torch.zeros((gb, self._tbl_cap), dtype=torch.int32, device=self.device),
                        torch.zeros((gb,), dtype=torch.int64, device=self.device), 0,
                        torch.zeros((gb,), dtype=torch.bool, device=self.device),
                        False, kc=kc, text_mode=text_mode,
                    )
                    _hidden_logits_group(
                        self.params, hidden, torch.zeros((gb,), dtype=torch.int64, device=self.device)
                    )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefix_stats(self) -> dict:
        """Prefix-cache counters (zeros when the cache is off)."""
        out = {"hits": 0, "misses": 0, "reused_pages": 0, "evicted": 0, "cached_pages": 0}
        if self.prefix_idx is not None:
            out.update(self.prefix_idx.stats())
        return out

    # ---- request lifecycle ----

    @property
    def _pending(self) -> Optional[_RegionRow]:
        """First still-prefilling pending row, or None."""
        for g in self._pending_groups:
            for rp in g.rows:
                if not rp.done:
                    return rp
        return None

    def has_work(self) -> bool:
        return super().has_work() or self._pending is not None

    def cancel(self, request_id: int) -> bool:
        for g in self._pending_groups:
            for rp in g.rows:
                if rp.done or rp.req.request_id != request_id:
                    continue
                # Mid-chunked-prefill: return the region's pages (reused
                # prefix pages hold a reference, fresh pages go back to the
                # free list). The row stays in its group as an inactive lane.
                rp.done = True
                g._active_dirty = True
                rp.req.done = True
                idx = self.prefix_idx
                for pid in rp.row_ids:
                    if idx is not None and idx.is_registered(pid):
                        idx.release(pid)
                    else:
                        self.free_pages.append(pid)
                if g.done:
                    self._pending_groups.remove(g)
                return True
        return super().cancel(request_id)

    def _admit(self):
        # Reclaim before admitting (a slot vacated by the previous step still
        # holds pages the incoming allocation may need) ...
        self._reclaim_vacated()
        if self._cp_chunk:
            events = self._admit_chunked()
        else:
            events = super()._admit()
        # ... and after: requests that finished AT admission vacated their
        # slot inside the loop above.
        self._reclaim_vacated()
        return events

    def _reclaim_vacated(self) -> None:
        """Free pages still attached to empty inactive slots (a pending
        chunked prefill's slot legitimately holds pages while inactive)."""
        pend_slots = {rp.slot for g in self._pending_groups for rp in g.rows if not rp.done}
        for slot in range(self.max_batch):
            if slot in pend_slots:
                continue
            if not self.active[slot] and self.slots[slot] is None and self.row_pages[slot]:
                self._free_row(slot)

    # ---- chunked admission (prefill/decode interleaving) ----

    def _admit_chunked(self) -> List[Tuple[int, int, bool]]:
        """Advance prefill work by one batched chunk per step while rows
        decode, or to completion when none does (nothing to interleave
        against). Compatible staged admissions form lockstep groups."""
        events: List[Tuple[int, int, bool]] = []
        while True:
            with self.timer.measure("admit_stage"):
                events += self._fill_pending()
            if not self._pending_groups:
                break
            g = self._pending_groups[0]  # FIFO: drain the oldest first
            with self.timer.measure("admit_chunk"):
                events += self._advance_group(g)
            if g.done:
                self._pending_groups.pop(0)
            if self.active.any():
                break  # decode work exists: at most one chunk this step
        return events

    def _fill_pending(self) -> List[Tuple[int, int, bool]]:
        """Stage every queued request that can claim a free slot (plan + page
        allocation + group formation); forwards run later, one batched chunk
        per `_advance_group`. A prompt mostly covered by an in-flight
        admission's soon-to-be-published pages waits for them."""
        events: List[Tuple[int, int, bool]] = []
        claimed = set()
        inflight = set()
        page = self.page_size
        for g in self._pending_groups:
            for rp in g.rows:
                if rp.done or not g.admit:
                    continue
                claimed.add(rp.slot)
                inflight.update(rp.hashes[rp.m : rp.req.prompt_len // page])
        staged = []
        waiting: List[Request] = []
        while self.queue:
            free = [
                s for s in range(self.max_batch)
                if not self.active[s] and self.slots[s] is None and s not in claimed
            ]
            if not free:
                break
            req = self.queue.pop(0)
            try:
                st = self._stage_admission(req, free[0], inflight, others_staged=bool(staged))
            except ValueError as e:
                # Oversized prompt / pool too small: fail this request.
                req.done = True
                req.error = str(e)
                self._record_failure(req)
                events.append((req.request_id, self.eos_id, True))
                continue
            except _WaitForPublish:
                waiting.append(req)  # retry next step
                continue
            except DeferAdmission:
                break
            claimed.add(free[0])
            staged.append(st)
            rp = st[0]
            inflight.update(rp.hashes[rp.m : req.prompt_len // page])
        self.queue[:0] = waiting
        if staged:
            self._pending_groups += self._form_groups(staged, chunk=self._cp_chunk, admit=True)
        return events

    def _stage_admission(self, req: Request, slot: int, inflight=(), others_staged: bool = False):
        """Plan + allocate pages for a chunked admission (the front half of
        `_prefill`, with prefix reuse and the defer-on-exhaustion rule);
        returns the staging tuple `_form_groups` consumes."""
        if self.row_pages[slot]:
            self._free_row(slot)
        t0 = time.perf_counter()
        pp = self._prefill_params(req)
        plan, arrays, px = self._plan_request(req, pad_round=self.page_size)
        page = self.page_size
        n_used = -(-req.prompt_len // page)

        idx = self.prefix_idx
        reused: List[int] = []
        hashes: List[bytes] = []
        if idx is not None:
            hashes = chain_hashes(
                content_key_ids(plan, req), page, salt=self._cache_salt(plan, req)
            )
            reused = idx.match(hashes[: (req.prompt_len - 1) // page])
        m = len(reused)

        if inflight and hashes:
            # Chained hashes: consecutive membership == shared prefix.
            extra = 0
            for h in hashes[m : (req.prompt_len - 1) // page]:
                if h not in inflight:
                    break
                extra += 1
            if extra and 2 * extra >= n_used:
                for pid in reused:
                    idx.release(pid)
                raise _WaitForPublish()

        try:
            ids = self._alloc(n_used - m)
        except PoolExhausted as e:
            for pid in reused:
                idx.release(pid)
            if not self.active.any() and self._pending is None and not others_staged:
                # Nothing could ever free pages: this request cannot fit.
                raise ValueError(str(e))
            self.queue.insert(0, req)
            raise DeferAdmission()

        rp = _RegionRow(
            req=req, row_ids=reused + ids, m=m, start=m * page,
            region=(n_used - m) * page, last_idx=req.prompt_len - 1 - m * page,
        )
        rp.hashes = hashes
        rp.slot = slot
        rp.t0 = t0
        return (rp, plan, pp, req)

    def _finish_admission(self, rp: _RegionRow) -> List[Tuple[int, int, bool]]:
        """Activate a fully-prefilled pending request: publish its prefix
        pages, install its table row, sample the first token."""
        req, slot = rp.req, rp.slot
        page = self.page_size
        n_used = len(rp.row_ids)
        idx = self.prefix_idx
        if idx is not None:
            for i in range(rp.m, req.prompt_len // page):
                idx.register(rp.hashes[i], rp.row_ids[i])
        self.row_pages[slot] = rp.row_ids
        self.lengths[slot] = req.prompt_len
        self.table[slot, :] = 0
        self.table[slot, :n_used] = rp.row_ids
        self._table_dirty = True

        first_tok = self._sample_first(rp.logits, req)
        req.slot = slot
        req.generated.append(first_tok)
        self.slots[slot] = req
        self.active[slot] = True
        self.temps[slot] = req.temperature
        self.top_ps[slot] = req.top_p
        self._flags_dirty = True
        self._tok_writes.append((slot, first_tok, req))
        done = first_tok == self.eos_id or len(req.generated) >= req.max_new_tokens
        self._on_admitted(slot, req, first_tok, done)
        if done:
            req.done = True
            self._release_slot(slot)
        return [(req.request_id, first_tok, done)]

    def _cache_salt(self, plan, req: Request) -> str:
        """Prefix-cache partition key: the LoRA adapter and the text-embedding
        route (a seg-carrying request embeds its text through vcoder_lm_emb,
        so identical leading text produces different KV)."""
        use_vemb = plan.use_vcoder_emb and self.cfg.use_vcoder_lm_emb
        return f"{req.lora or ''}|e{int(bool(use_vemb))}"

    def _prefill(self, req: Request, slot: int) -> int:
        # The previous occupant may have finished at admission and this slot
        # is being reused within the same _admit loop: reclaim.
        if self.row_pages[slot]:
            self._free_row(slot)
        pp = self._prefill_params(req)
        plan, arrays, px = self._plan_request(req, pad_round=self.page_size)
        page = self.page_size
        n_used = -(-req.prompt_len // page)

        idx = self.prefix_idx
        reused: List[int] = []
        hashes: List[bytes] = []
        if idx is not None:
            hashes = chain_hashes(
                content_key_ids(plan, req), page, salt=self._cache_salt(plan, req)
            )
            # Keep >= 1 suffix token so first-token logits exist.
            reused = idx.match(hashes[: (req.prompt_len - 1) // page])
            if reused and (n_used - len(reused)) * page > self.prefix_max_suffix:
                # Long suffix: the dense prefill beats many chunked verify
                # steps -- drop the reuse, re-prefill densely.
                for pid in reused:
                    idx.release(pid)
                reused = []
        m = len(reused)

        try:
            ids = self._alloc(n_used - m)
        except PoolExhausted as e:
            for pid in reused:
                idx.release(pid)
            if not self.active.any():
                # Nothing running that could ever free pages.
                raise ValueError(str(e))
            self.queue.insert(0, req)
            raise DeferAdmission()
        row_ids = reused + ids

        if m:
            logits = self._suffix_prefill(pp, req, plan, arrays, px, row_ids, m)
        else:
            logits = self._dense_prefill_scatter(pp, req, plan, arrays, px, ids)

        if idx is not None:
            # Publish the prompt's fully-covered pages (decode writes land at
            # positions >= prompt_len, so they stay immutable).
            for i in range(m, req.prompt_len // page):
                idx.register(hashes[i], row_ids[i])

        self.row_pages[slot] = row_ids
        self.lengths[slot] = req.prompt_len
        self.table[slot, :] = 0
        self.table[slot, :n_used] = row_ids
        self._table_dirty = True
        return self._sample_first(logits, req)

    def _dense_prefill_scatter(self, pp, req, plan, arrays, px, ids) -> torch.Tensor:
        n_used = len(ids)
        with torch.no_grad():
            logits, tmp_k, tmp_v = _dense_prefill(
                pp, self.cfg, arrays, px(req.images), px(req.segs), px(req.depths),
                use_vcoder_emb=plan.use_vcoder_emb and self.cfg.use_vcoder_lm_emb,
                attn_impl=self.attn_impl,
            )
            page_ids = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
            if self.kv_quant:
                _scatter_pages_q8(
                    self.k_pages, self.v_pages, self.k_scale, self.v_scale, tmp_k, tmp_v,
                    page_ids, n_pages_used=n_used,
                )
            else:
                _scatter_pages(
                    self.k_pages, self.v_pages, tmp_k, tmp_v, page_ids, n_pages_used=n_used
                )
        return logits

    def _suffix_prefill(self, pp, req, plan, arrays, px, row_ids, m):
        """Prefill only the suffix [m*page, ceil(prompt/page)*page) over the
        ``m`` reused prefix pages, in page-multiple chunks through the paged
        verify forward. Pads write garbage KV into this row's own pages at
        positions >= prompt_len: never attended, overwritten by decode."""
        page = self.page_size
        rp = _RegionRow(
            req=req, row_ids=row_ids, m=m, start=m * page,
            region=(len(row_ids) - m) * page, last_idx=req.prompt_len - 1 - m * page,
        )
        g = self._form_groups([(rp, plan, pp, req)], chunk=self._chunk, admit=False)[0]
        while not g.done:
            self._advance_group(g)
        return rp.logits

    def _form_groups(self, staged, *, chunk: int, admit: bool) -> List[_PrefillGroup]:
        """Partition staged admissions into lockstep groups: rows must agree
        on the padded plan length, the modality signature, the embedding
        route and the adapter. Mixed traffic degrades to smaller groups."""
        by_key = {}
        for st in staged:
            rp, plan, pp, req = st
            T_pad = plan.safe_ids.shape[1]
            end = min(rp.start + rp.region, T_pad)
            # Skip the vision encode when every VALID region position is text
            # (pad positions are is_text=False but carry no content).
            end_valid = min(end, int(plan.seq_lens[0]))
            text_only = bool(plan.is_text[0, rp.start:end_valid].all())
            use_vemb = plan.use_vcoder_emb and self.cfg.use_vcoder_lm_emb
            mods = None if text_only else tuple(
                np.asarray(x).shape if x is not None else None
                for x in (req.images, req.segs, req.depths)
            )
            key = (text_only, T_pad, use_vemb, req.lora, mods)
            by_key.setdefault(key, []).append(st)
        groups = []
        cap = _G_BUCKETS[-1]
        for (text_only, T_pad, use_vemb, _lora, _mods), items in by_key.items():
            for i0 in range(0, len(items), cap):
                part = items[i0 : i0 + cap]
                if admit:
                    self.admit_group_sizes.append(len(part))
                groups.append(self._build_group(
                    part, text_only=text_only, T_pad=T_pad, use_vemb=use_vemb,
                    chunk=chunk, admit=admit,
                ))
        return groups

    def _group_vis_tables(self, items, gb: int, pp) -> torch.Tensor:
        """Per-row vision tables [gb, N_vis, D] through an LRU keyed by pixel
        digest (+ adapter): repeated media (multi-turn, shared images) reuses
        the cached table; misses batch into one tower pass. Pad rows repeat
        row 0 (their positions never select vision values)."""
        keys = []
        for (_rp, _plan, _pp, req) in items:
            h = hashlib.sha256()
            for arr in (req.images, req.segs, req.depths):
                if arr is not None:
                    a = np.ascontiguousarray(arr)
                    h.update(str(a.shape).encode())
                    h.update(a.tobytes())
            keys.append((h.digest(), req.lora))
        req0 = items[0][3]
        present = [
            name for name in ("images", "segs", "depths") if getattr(req0, name) is not None
        ]
        miss = [i for i, k in enumerate(keys) if k not in self._vis_cache]
        if miss:
            mb = _g_bucket(len(miss))
            dtype = self.params["lm"]["embed_tokens"].dtype
            mod = {}
            for name in present:
                first = np.asarray(getattr(req0, name))
                stacked = np.zeros((mb,) + first.shape[1:], np.float32)
                for j, i in enumerate(miss):
                    stacked[j] = np.asarray(getattr(items[i][3], name))[0]
                mod[name] = torch.as_tensor(stacked).to(self.device, dtype)
            with torch.no_grad():
                tbl = _encode_vision_group(
                    pp, self.cfg, mod.get("images"), mod.get("segs"), mod.get("depths"),
                    attn_impl=self.attn_impl,
                )
            for j, i in enumerate(miss):
                self._vis_cache[keys[i]] = tbl[j]
        rows = []
        for k in keys:
            rows.append(self._vis_cache[k])
            self._vis_cache.move_to_end(k)
        # Evict AFTER touching the group's keys (cap >= max group size).
        while len(self._vis_cache) > self._vis_cache_cap:
            self._vis_cache.popitem(last=False)
        while len(rows) < gb:
            rows.append(rows[0])
        return torch.stack(rows)

    def _build_group(self, items, *, text_only: bool, T_pad: int, use_vemb: bool,
                     chunk: int, admit: bool) -> _PrefillGroup:
        """A row's final chunk may overhang its region by up to chunk - page
        positions: sources and tables are padded to engine-constant caps, so
        the lockstep slice never clamps into valid data and overhang
        positions index real (sentinel) table entries."""
        G = len(items)
        gb = _g_bucket(G)  # inactive pad rows write the scratch page
        T_r = self._src_cap
        pp = items[0][2]
        tables = np.zeros((gb, self._tbl_cap), np.int32)
        starts = np.zeros((gb,), np.int64)
        rows: List[_RegionRow] = []
        for i, (rp, _plan, _pp, _req) in enumerate(items):
            tables[i, : len(rp.row_ids)] = rp.row_ids
            starts[i] = rp.start
            rows.append(rp)

        def stack_plan(field, fill):
            first = getattr(items[0][1], field)[0]
            out = np.full((gb, T_r), fill, dtype=first.dtype)
            for i, (_rp, plan, _pp, _req) in enumerate(items):
                out[i, :T_pad] = getattr(plan, field)[0]
            return out

        if text_only:
            source = torch.as_tensor(stack_plan("safe_ids", 0), device=self.device).long()
        else:
            plan_arrays = {
                "safe_ids": torch.as_tensor(stack_plan("safe_ids", 0), device=self.device).long(),
                "is_text": torch.as_tensor(stack_plan("is_text", True), device=self.device),
                "vis_idx": torch.as_tensor(stack_plan("vis_idx", 0), device=self.device).long(),
            }
            vis_table = self._group_vis_tables(items, gb, pp)
            source = _assemble_group(pp, plan_arrays, vis_table, use_vemb)
        return _PrefillGroup(
            rows=rows, params=pp, source=source, text_mode=text_only, use_vemb=use_vemb,
            tables=torch.as_tensor(tables, device=self.device),
            starts=torch.as_tensor(starts, device=self.device), chunk=chunk, admit=admit,
        )

    def _advance_group(self, g: _PrefillGroup) -> List[Tuple[int, int, bool]]:
        """Run ONE lockstep chunk for every live row of a group; rows whose
        region completes are finished into decode slots (admit groups) or
        left holding their first-token logits (the suffix prefill)."""
        kc = g.chunk
        with torch.no_grad():
            hidden = _group_chunk(
                g.params, self.cfg, g.source, self.k_pages, self.v_pages, self.k_scale,
                self.v_scale, g.tables, g.starts, g.off, g.active_dev(), g.use_vemb,
                kc=kc, text_mode=g.text_mode,
            )
            finishing: List[_RegionRow] = []
            landing = []  # rows whose last prompt token sits in this chunk
            for i, rp in enumerate(g.rows):
                if rp.done:
                    continue
                if g.off <= rp.last_idx < g.off + kc:
                    landing.append((i, rp))
                if g.off + kc >= rp.region:
                    rp.done = True
                    g._active_dirty = True
                    finishing.append(rp)
            if landing:
                idxs = np.zeros((hidden.shape[0],), np.int64)
                for i, rp in landing:
                    idxs[i] = rp.last_idx - g.off
                logits = _hidden_logits_group(
                    g.params, hidden, torch.as_tensor(idxs, device=self.device)
                )
                for i, rp in landing:
                    rp.logits = logits[i]
        g.off += kc
        events: List[Tuple[int, int, bool]] = []
        if g.admit:
            for rp in finishing:
                self.timer.record("ttft", time.perf_counter() - rp.t0)
                events += self._finish_admission(rp)
        return events

    def _ensure_pages(self, events) -> None:
        """Give every active row pages covering its write horizon (one token,
        the sync window or the speculative window). A row that cannot get one
        is preempted by recompute, or ended when nothing could free pages."""
        horizon = self.spec_k if self.spec_k else self.sync_every
        for slot in range(self.max_batch):
            if not self.active[slot]:
                continue
            pos_last = int(self.lengths[slot]) + horizon - 1
            needed_total = pos_last // self.page_size + 1
            if needed_total > self.p_max:
                ended = self._end_request(slot, "context reached max_len")
                events.append((ended.request_id, self.eos_id, True))
                continue
            while len(self.row_pages[slot]) < needed_total:
                try:
                    pid = self._alloc(1)[0]
                except PoolExhausted:
                    if self.active.sum() > 1 or self._pending is not None:
                        # Other rows (or a pending chunked admission) will
                        # free pages: requeue this one for recompute.
                        self._preempt_requeue(slot)
                    else:
                        ended = self._end_request(slot, "preempted: page pool exhausted")
                        events.append((ended.request_id, self.eos_id, True))
                    break
                idx = len(self.row_pages[slot])
                self.row_pages[slot].append(pid)
                self.table[slot, idx] = pid
                self._table_dirty = True

    def _flush_tokens(self) -> None:
        """Apply deferred first-token writes before the next decode; writes
        whose slot has since been released or reused are dropped."""
        if not self._tok_writes:
            return
        live = [(s, t) for s, t, r in self._tok_writes if self.slots[s] is r]
        self._tok_writes.clear()
        for s, t in live:
            self.tokens[s] = t

    def step(self) -> List[Tuple[int, int, bool]]:
        events = self._admit()
        if not self.active.any():
            return events
        self._ensure_pages(events)
        if not self.active.any():
            return events
        self._flush_tokens()
        if self.spec_k:
            return events + self._step_speculative_paged()
        table_dev = self._device_table()
        active_dev, temps_dev, top_ps_dev = self._device_flags()
        # Adaptive window: while admissions are queued or mid-chunk, decode
        # ONE step per engine step; idle queues keep the full window.
        steps = 1 if (self.queue or self._pending_groups) else self.sync_every
        with self.timer.measure("decode_step"), torch.no_grad():
            toks, self.tokens = _paged_decode_all_n(
                self.params, self.cfg, self.tokens, self.k_pages, self.v_pages,
                self.k_scale, self.v_scale, table_dev,
                torch.as_tensor(self.lengths, device=self.device), active_dev,
                temps_dev, top_ps_dev, self.rng, steps=steps,
                nucleus=self._nucleus(), sampling=self._sampling(),
            )
            toks_host = toks.cpu().numpy()  # [N, B]
        self.lengths += steps * self.active.astype(np.int32)
        return events + self._emit_step_events(toks_host)

    def _release_slot(self, slot: int) -> None:
        super()._release_slot(slot)
        self._free_row(slot)

    def _step_speculative_paged(self) -> List[Tuple[int, int, bool]]:
        """One speculative verify step over paged KV for all slots."""
        draft, budget = self._spec_host_inputs()
        table_dev = self._device_table()
        active_dev, temps_dev, top_ps_dev = self._device_flags()
        with self.timer.measure("decode_step"), torch.no_grad():
            outs, emit, self.tokens = _paged_spec_decode_all(
                self.params, self.cfg, self.tokens,
                torch.as_tensor(draft, device=self.device).long(),
                self.k_pages, self.v_pages, self.k_scale, self.v_scale, table_dev,
                torch.as_tensor(self.lengths, device=self.device), active_dev,
                torch.as_tensor(budget, device=self.device), temps_dev, top_ps_dev,
                self.rng, self.eos_id, nucleus=self._nucleus(), sampling=self._sampling(),
            )
            outs_host, emit_host = outs.cpu().numpy(), emit.cpu().numpy()
        self.lengths += emit_host.astype(np.int32)
        return self._emit_window_events(outs_host, emit_host)

    def _preempt_requeue(self, slot: int) -> None:
        """Preemption by recompute: vacate the slot, return its pages, fold
        the tokens generated so far into the prompt, and requeue at the
        FRONT; greedy generation continues exactly where it stopped."""
        req = self.slots[slot]
        req.input_ids = list(req.input_ids) + [int(t) for t in req.new_ids()]
        req.folded = len(req.generated)
        req.slot = -1
        self._release_slot(slot)  # frees the row's pages too
        self.queue.insert(0, req)
        self.preemptions += 1

    def _end_request(self, slot: int, reason: str) -> Request:
        req = self.slots[slot]
        req.done = True
        req.error = reason
        self._record_failure(req)
        self._release_slot(slot)
        return req


class PoolExhausted(RuntimeError):
    pass


class _WaitForPublish(Exception):
    """Staging bailout: most of this prompt's pages are being prefilled by an
    in-flight admission; wait for their publication."""
