"""Block-paged KV pool bookkeeping, host side (counterpart of
``paddle_tpu/serving/paged_kv.py``).

The device arrays are ``[L, P, page_size, nh, d]`` — P physical pages
shared by every slot — plus a host-authoritative slot->page table
``[B, MP]`` uploaded with each dispatch. This module owns the pure
bookkeeping:

* **free-page allocator** with refcounts. Page 0 is the reserved TRASH
  page: never handed out, the write target of padding lanes and inactive
  slots, and the read target of unmapped table entries (always masked).
* **prefix cache**: hash-matched prompt prefixes map the SAME physical
  pages (refcount + 1) instead of recomputing their KV. Cumulative
  full-page entries (``prompt[:k*page_size]`` -> page) and exact-prompt
  entries (whole prompt -> all its pages, partial last page included),
  evicted LRU when admission needs pages.
* **copy-on-write**: a slot may only WRITE a page it owns alone;
  ``make_writable`` remaps any shared page in the write range to a fresh
  one and returns the copies the engine must run first.

Sharing is bitwise-safe because a token's KV depends only on the tokens
before it. A quantized pool (int8/fp8, serving/quant.py) also owns
per-page dequant scales ``k_scale``/``v_scale`` [L, P]: the page is the
quantization block, so a copy-on-write split copies the source page's
scale entries with its bytes, prefix sharing shares a page with its
scales, and the trash page keeps scale 1.0. Transfer staging and
snapshots come with the slices that need them.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np


class PagePoolExhausted(RuntimeError):
    """No free physical page available (after cache eviction)."""


def pages_for(tokens, page_size):
    """Number of pages covering ``tokens`` positions."""
    return -(-int(tokens) // int(page_size))


class PagedKVPool:
    """Allocator + slot page table + prefix cache. The device KV arrays
    live in the engine; this class only decides WHICH physical page each
    (slot, logical page) maps to."""

    def __init__(self, num_slots, max_seq_len, page_size, num_pages=0,
                 prefix_cache=True, kv_dtype="bf16", num_layers=0,
                 k_clip=None, v_clip=None, qmax=127.0):
        self.page_size = int(page_size)
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.slot_pages = pages_for(max_seq_len, self.page_size)  # MP
        self.num_slots = int(num_slots)
        self.num_pages = int(num_pages) or \
            self.num_slots * self.slot_pages + 1
        if self.num_pages < 2:
            raise ValueError("need at least 2 pages (one is the trash page)")
        # quantized pool: every page of layer l starts at clip[l] / qmax
        self.kv_dtype = str(kv_dtype)
        self.k_scale = self.v_scale = None
        if self.kv_dtype != "bf16":
            if not num_layers or k_clip is None or v_clip is None:
                raise ValueError(
                    "a quantized pool needs num_layers and per-layer "
                    "k_clip/v_clip ranges (calibrate via serving.quant)")
            from .quant import page_scales
            L = int(num_layers)
            self.k_scale = page_scales(np.broadcast_to(
                np.asarray(k_clip, np.float64), (L,)), self.num_pages, qmax)
            self.v_scale = page_scales(np.broadcast_to(
                np.asarray(v_clip, np.float64), (L,)), self.num_pages, qmax)
        # slot -> physical page, logical order; 0 = unmapped/trash
        self.table = np.zeros((self.num_slots, self.slot_pages), np.int32)
        self.ref = np.zeros(self.num_pages, np.int64)
        self.ref[0] = 1                              # trash page, pinned
        self._free = list(range(self.num_pages - 1, 0, -1))  # pops ascending
        self._spare = [None] * self.num_slots        # per-slot CoW reserve
        self.prefix_cache_enabled = bool(prefix_cache)
        # LRU: (b"P", bytes) -> page id (full-page entries) or
        # (b"E", bytes) -> (tuple(pages), plen) (exact-prompt entries)
        self._cache = OrderedDict()
        self.allocated = 0                           # leak-audit counters
        self.freed = 0

    # -- allocator -----------------------------------------------------------
    @property
    def free_count(self):
        return len(self._free)

    @property
    def pages_in_use(self):
        return self.num_pages - 1 - len(self._free)

    def _alloc_one(self):
        if not self._free:
            self._evict_until(1)
        if not self._free:
            raise PagePoolExhausted(
                f"no free KV page ({self.num_pages - 1} pages all in use)")
        p = self._free.pop()
        self.ref[p] = 1
        self.allocated += 1
        return p

    def try_alloc(self, n):
        """Allocate n pages (evicting LRU cache entries if needed), or
        None when the pool cannot cover them; all or nothing."""
        if self.free_count < n:
            self._evict_until(n)
        if self.free_count < n:
            return None
        return [self._alloc_one() for _ in range(n)]

    def incref(self, pages):
        for p in pages:
            if p == 0:
                raise ValueError("the trash page is never shared")
            self.ref[p] += 1

    def decref(self, pages):
        for p in pages:
            if p == 0 or self.ref[p] <= 0:
                raise ValueError(f"decref of page {p} with refcount "
                                 f"{self.ref[p]}")
            self.ref[p] -= 1
            if self.ref[p] == 0:
                self._free.append(int(p))
                self.freed += 1

    # -- slot mapping --------------------------------------------------------
    def map_slot(self, b, pages, spare=None):
        """Bind ``pages`` (already ref-held by the caller) to slot b's
        logical pages 0..len-1, and park an optional CoW spare page."""
        self.table[b] = 0
        self.table[b, :len(pages)] = pages
        self._spare[b] = spare

    def release_slot(self, b):
        """Unmap slot b: decref every mapped page and the CoW spare."""
        mapped = [int(p) for p in self.table[b] if p != 0]
        self.table[b] = 0
        self.decref(mapped)
        if self._spare[b] is not None:
            self.decref([self._spare[b]])
            self._spare[b] = None

    def make_writable(self, b, start, end):
        """Make slot b the sole owner of every page covering positions
        [start, end): a page with refcount > 1 (another slot or the prefix
        cache holds it) is remapped to a fresh page. Returns the physical
        copies [(src, dst), ...] the engine runs BEFORE the dispatch that
        writes the range."""
        ps = self.page_size
        copies = []
        for li in range(start // ps, (end - 1) // ps + 1):
            phys = int(self.table[b, li])
            if phys == 0:
                raise RuntimeError(
                    f"slot {b} writes unmapped logical page {li}")
            if self.ref[phys] == 1:
                continue
            if self._spare[b] is not None:
                dst = self._spare[b]
                self._spare[b] = None
            else:
                dst = self._alloc_one()
            copies.append((phys, dst))
            self.table[b, li] = dst
            self.decref([phys])
            if self.k_scale is not None:
                # the copy inherits the source page's scales with its bytes
                self.k_scale[:, dst] = self.k_scale[:, phys]
                self.v_scale[:, dst] = self.v_scale[:, phys]
        return copies

    # -- prefix cache --------------------------------------------------------
    def lookup(self, prompt):
        """Longest cached prefix of ``prompt`` (np.int32 [plen]). Returns
        (matched_tokens, pages, exact): ``pages`` cover logical pages
        0..ceil(matched/page_size)-1 and are NOT ref-held yet (the caller
        increfs); exact=True when an exact-prompt entry matched."""
        if not self.prefix_cache_enabled:
            return 0, [], False
        raw = prompt.tobytes()
        hit = self._cache.get((b"E", raw))
        if hit is not None:
            self._cache.move_to_end((b"E", raw))
            pages, plen = hit
            return plen, list(pages), True
        ps = self.page_size
        pages = []
        for j in range(1, len(prompt) // ps + 1):
            key = (b"P", prompt[:j * ps].tobytes())
            page = self._cache.get(key)
            if page is None:
                break
            self._cache.move_to_end(key)
            pages.append(page)
        return len(pages) * ps, pages, False

    def register(self, prompt, b, min_free_frac=0.25):
        """Publish slot b's prompt pages into the cache (cumulative
        full-page entries + the exact-prompt entry). Called on slot
        RELEASE, when the prompt KV is complete and the slot writes these
        pages no more. Skipped under page pressure (free below
        ``min_free_frac`` of the pool), so one-off prompts do not evict
        hot shared prefixes."""
        if not self.prefix_cache_enabled:
            return
        if self.free_count < max(1, int((self.num_pages - 1)
                                        * min_free_frac)):
            return
        ps = self.page_size
        row = self.table[b]
        for j in range(1, len(prompt) // ps + 1):
            key = (b"P", prompt[:j * ps].tobytes())
            if key not in self._cache:
                page = int(row[j - 1])
                self._cache[key] = page
                self.incref([page])
        ekey = (b"E", prompt.tobytes())
        if ekey not in self._cache:
            pages = tuple(int(p) for p in row[:pages_for(len(prompt), ps)])
            self._cache[ekey] = (pages, len(prompt))
            self.incref(pages)

    def _evict_until(self, need_free):
        """Drop LRU cache entries until ``need_free`` pages are free (or
        the cache is empty). Pages still mapped by running slots survive:
        eviction only drops the cache's pin."""
        while self._cache and self.free_count < need_free:
            key, val = self._cache.popitem(last=False)
            self.decref([val] if key[0] == b"P" else list(val[0]))

    # -- audit ---------------------------------------------------------------
    def balance(self):
        """Conservation snapshot for the leak gate: free + in-use must
        equal num_pages - 1, and refcounts must account for every slot
        mapping, spare and cache pin."""
        slot_refs = np.zeros(self.num_pages, np.int64)
        for b in range(self.num_slots):
            for p in self.table[b]:
                if p != 0:
                    slot_refs[p] += 1
            if self._spare[b] is not None:
                slot_refs[self._spare[b]] += 1
        cache_refs = np.zeros(self.num_pages, np.int64)
        for key, val in self._cache.items():
            for p in ([val] if key[0] == b"P" else val[0]):
                cache_refs[p] += 1
        accounted = bool((self.ref[1:] ==
                          (slot_refs + cache_refs)[1:]).all())
        return {
            "num_pages": self.num_pages,
            "free": self.free_count,
            "in_use": self.pages_in_use,
            "conserved": self.free_count + self.pages_in_use
            == self.num_pages - 1,
            "refcounts_accounted": accounted,
            "cache_entries": len(self._cache),
            "allocated": self.allocated,
            "freed": self.freed,
        }
