"""Automatic prefix caching for the paged-KV serving engine: a copy of
``vcoder_tpu/serve/prefix_cache.py`` (``content_key_ids:38``,
``chain_hashes:66``, ``PrefixIndex:88``; numpy and hashlib only). Keep the two
in step.

A full prompt page whose chained content hash matches an already-computed
page is mapped into the new request's page table instead of recomputed, and
only the suffix runs through the model.

Correctness invariants:

* A page is registered only when it is **fully covered by prompt
  tokens**; decode writes always land at positions >= prompt_len, i.e.
  in later pages, so registered pages are immutable.
* Hashes are **chained** (h_i covers blocks 0..i), so a hit at block i
  implies the whole causal prefix matches -- KV is positionally exact.
* Vision positions hash the **pixel content** (one digest over all
  modalities), never the sentinel ids: two prompts with identical token
  ids but different images can never alias.
* A hit never frees or mutates the donor's pages: reuse is
  refcounted, and eviction only takes pages with zero references.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["PrefixIndex", "content_key_ids", "chain_hashes"]


def content_key_ids(plan, req) -> np.ndarray:
    """Per-position content keys for one planned request: [T_valid] int64.

    Text positions use the token id; vision positions use a surrogate
    mixing a digest of ALL the request's pixel arrays with the position's
    index into the vision table (so any pixel change re-keys every vision
    position — over-conservative, never a false hit)."""
    T = int(plan.seq_lens[0])
    ids = plan.safe_ids[0, :T].astype(np.int64).copy()
    is_text = plan.is_text[0, :T]
    if not bool(is_text.all()):
        digest = hashlib.sha256()
        for arr in (req.images, req.segs, req.depths):
            if arr is not None:
                a = np.ascontiguousarray(arr)
                digest.update(str(a.shape).encode())
                digest.update(a.tobytes())
        base = np.int64(
            int.from_bytes(digest.digest()[:8], "little") % (1 << 62)
        )
        vis_idx = plan.vis_idx[0, :T].astype(np.int64)
        # Knuth-mix the digest with the table index; set the sign bit so
        # surrogates can never collide with real (non-negative) token ids.
        surrogate = -(((base + vis_idx) * np.int64(2654435761)) % (1 << 62)) - 1
        ids = np.where(is_text, ids, surrogate)
    return ids


def chain_hashes(
    key_ids: np.ndarray, page_size: int, salt: str = ""
) -> List[bytes]:
    """Chained content hash per FULL page: h_i = H(h_{i-1} || block_i).

    Only blocks fully inside ``key_ids`` are hashed — the partial tail
    page of a prompt is never shareable (its remaining slots get decode
    writes). ``salt`` partitions the cache by anything that changes the
    KV for identical token content (multi-LoRA: the adapter name — the
    same prompt under adapter X and Y must never share pages)."""
    n_full = len(key_ids) // page_size
    out: List[bytes] = []
    prev = b"vcoder-prefix-v1" + salt.encode()
    for i in range(n_full):
        h = hashlib.sha256()
        h.update(prev)
        h.update(key_ids[i * page_size : (i + 1) * page_size].tobytes())
        prev = h.digest()
        out.append(prev)
    return out


class PrefixIndex:
    """hash -> page map with refcounts and LRU eviction (one per shard;
    page ids are shard-local ranges of the global pool)."""

    def __init__(self) -> None:
        self.by_hash: Dict[bytes, int] = {}
        self.page_hash: Dict[int, bytes] = {}
        self.refs: Dict[int, int] = {}
        # Registered pages with refs == 0, oldest-used first — the only
        # pages eviction may take.
        self.evictable: "OrderedDict[int, None]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.reused_pages = 0
        self.evicted = 0

    # ---- lookup / reuse ----

    def match(self, hashes: Sequence[bytes]) -> List[int]:
        """Longest prefix of ``hashes`` present in the index. Bumps each
        matched page's refcount (caller OWNS the reuse; pair with
        :meth:`release`) and marks it recently used."""
        pages: List[int] = []
        for h in hashes:
            pid = self.by_hash.get(h)
            if pid is None:
                break
            self.refs[pid] += 1
            self.evictable.pop(pid, None)
            pages.append(pid)
        if pages:
            self.hits += 1
            self.reused_pages += len(pages)
        else:
            self.misses += 1
        return pages

    # ---- registration / release ----

    def register(self, h: bytes, page_id: int) -> bool:
        """Publish a freshly-filled full prompt page under its chain
        hash. No-op (False) if the hash is already served by another
        page — the caller's page stays exclusively owned."""
        if h in self.by_hash or page_id in self.page_hash:
            return False
        self.by_hash[h] = page_id
        self.page_hash[page_id] = h
        self.refs[page_id] = self.refs.get(page_id, 0) + 1
        return True

    def is_registered(self, page_id: int) -> bool:
        return page_id in self.page_hash

    def release(self, page_id: int) -> None:
        """Drop one reference. At zero the page becomes evictable but its
        KV stays cached for future hits."""
        self.refs[page_id] -= 1
        if self.refs[page_id] == 0:
            self.evictable[page_id] = None
            self.evictable.move_to_end(page_id)

    # ---- eviction ----

    def evict(self, n: int) -> List[int]:
        """Unregister up to ``n`` least-recently-used zero-ref pages and
        return them (the caller returns them to the free list)."""
        out: List[int] = []
        while len(out) < n and self.evictable:
            pid, _ = self.evictable.popitem(last=False)
            h = self.page_hash.pop(pid)
            del self.by_hash[h]
            del self.refs[pid]
            out.append(pid)
        self.evicted += len(out)
        return out

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "reused_pages": self.reused_pages,
            "evicted": self.evicted,
            "cached_pages": len(self.page_hash),
        }
