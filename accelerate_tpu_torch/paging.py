"""Host-side page-pool allocator and shared-prefix cache for paged KV serving.

The port's own copy of `accelerate_tpu/paging.py` (the port imports nothing of
the JAX package). The device side of the paged cache is dumb on purpose: one
pool of fixed-size KV pages per layer (`ops/attention.slot_cache_attention`)
plus per-slot int32 page tables. ALL policy lives here, on the host, between
dispatches:

  - **PagePool** — a free-list allocator with per-page refcounts over pages
    `1..num_pages-1` (page 0 is the reserved SCRATCH page: inactive slots'
    table rows point at it so their discarded writes can never corrupt a live
    request, and shared-prefix table entries are redirected to it at insert so
    a registered read-only page is written exactly once, at creation).
  - **Prefix cache** — chain hashes of prompt token prefixes at page
    granularity (`chain_hashes`): the digest for page i covers tokens
    `[0, (i+1)*page_size)`, so a hash match implies bitwise-identical KV
    content (K/V at position j depends only on tokens `<= j` under causal
    attention, and rotary embeddings are absolute-position aligned). Matched
    pages are shared read-only across requests with refcount pins; a released
    shared page stays CACHED (refcount 0, evictable LRU) rather than free, so
    the next request with the same system prompt pays zero prefill FLOPs and
    zero duplicate HBM for it.

Admission is reserve-on-admit: the engine reserves the request's whole
worst-case footprint `ceil((prompt + max_new_tokens) / page_size)` pages
(minus matched prefix pages) before the insert dispatch, so a request that
admits can always run to completion — no mid-flight pool exhaustion, no
preemption machinery — while capacity stays proportional to each request's
ACTUAL footprint instead of the engine-wide `max_length` worst case.

Pure host Python (no torch imports): allocator calls sit on the serving hot
path between dispatches and must never touch the device.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np

#: Pool page 0 — never allocated; absorbs writes the engine wants discarded.
SCRATCH_PAGE = 0


def pages_for(num_tokens: int, page_size: int) -> int:
    """Pages covering `num_tokens` cache positions (ceil division) — the
    admission footprint formula. Speculative engines pass
    `prompt + max_new + draft_tokens`: the draft window's rejected writes land
    through the slot's own page table, so the window counts against the
    reservation like real tokens (positions past the table's last entry fall
    through to the scratch page and are discarded)."""
    return -(-int(num_tokens) // int(page_size))


def chain_hashes(tokens, page_size: int) -> List[str]:
    """Chain digest per FULL page of a token sequence: entry i is the SHA-256
    over tokens `[0, (i+1)*page_size)` (running hash, so a page's digest commits
    to its whole prefix — two prompts share page i iff they agree on every token
    through page i). Partial trailing pages get no hash: prefix sharing is
    page-granular by design."""
    ids = np.asarray(tokens, np.int32).reshape(-1)
    digest = hashlib.sha256()
    out: List[str] = []
    for i in range(ids.size // page_size):
        digest.update(ids[i * page_size : (i + 1) * page_size].tobytes())
        out.append(digest.hexdigest())
    return out


class PagePool:
    """Refcounted page allocator + page-granular prefix cache (host side).

    Page states (mutually exclusive):
      - **free**: on the free list, content meaningless.
      - **in use**: refcount >= 1 — owned by one request (private pages) or
        pinned by every request currently sharing it (registered prefix pages).
      - **cached**: refcount == 0 but registered in the prefix cache — content
        is a valid shared prefix awaiting its next hit; evicted LRU only when
        `reserve` finds the free list short.

    `pages_in_use + pages_free + pages_cached == pages_total` always (the
    scratch page is outside the ledger); `check_consistency()` verifies the
    invariants and is pinned by the chaos page-ledger check.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the reserved scratch page)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.evictions = 0
        self._init_state()

    def _init_state(self):
        self._refcount = np.zeros(self.num_pages, np.int64)
        # LIFO free list: a just-freed (hot) page is reused first.
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._page_of_hash: Dict[str, int] = {}
        self._hash_of_page: Dict[int, str] = {}
        self._lru: Dict[int, int] = {}  # cached page -> last-touch tick (dict = insertion order fallback)
        self._tick = 0

    # ------------------------------------------------------------------ ledger
    @property
    def pages_total(self) -> int:
        """Usable pages (the scratch page is not allocatable)."""
        return self.num_pages - 1

    @property
    def pages_in_use(self) -> int:
        return int((self._refcount[1:] > 0).sum())

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_cached(self) -> int:
        """Unreferenced prefix pages held for reuse (evictable)."""
        return len(self._lru)

    @property
    def prefix_entries(self) -> int:
        return len(self._page_of_hash)

    def check_consistency(self) -> List[str]:
        """Structural invariants; every violation is a leak or a
        use-after-free in the making. Empty list == healthy."""
        problems: List[str] = []
        if SCRATCH_PAGE in self._free or SCRATCH_PAGE in self._lru:
            problems.append("scratch page entered the allocatable set")
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            problems.append("duplicate pages on the free list")
        for page in free_set:
            if self._refcount[page] != 0:
                problems.append(f"free page {page} has refcount {self._refcount[page]}")
            if page in self._hash_of_page:
                problems.append(f"free page {page} still registered in the prefix cache")
        for page in self._lru:
            if self._refcount[page] != 0:
                problems.append(f"cached page {page} has refcount {self._refcount[page]}")
            if page not in self._hash_of_page:
                problems.append(f"cached page {page} has no prefix registration")
            if page in free_set:
                problems.append(f"page {page} is both cached and free")
        for digest, page in self._page_of_hash.items():
            if self._hash_of_page.get(page) != digest:
                problems.append(f"hash map asymmetry for page {page}")
        accounted = self.pages_in_use + self.pages_free + self.pages_cached
        if accounted != self.pages_total:
            problems.append(
                f"ledger mismatch: in_use {self.pages_in_use} + free {self.pages_free} "
                f"+ cached {self.pages_cached} != total {self.pages_total}"
            )
        return problems

    # -------------------------------------------------------------- allocation
    def reserve(self, count: int) -> Optional[List[int]]:
        """Take `count` pages (refcount 1 each), evicting LRU cached prefix
        pages if the free list runs short. Returns None — reserving NOTHING —
        when even eviction cannot cover the request, so a failed admission
        never partially drains the pool."""
        if count < 0:
            raise ValueError("count must be >= 0")
        if count > len(self._free) + len(self._lru):
            return None
        taken: List[int] = []
        for _ in range(count):
            if self._free:
                page = self._free.pop()
            else:
                page = min(self._lru, key=self._lru.__getitem__)  # oldest tick
                del self._lru[page]
                digest = self._hash_of_page.pop(page)
                self._page_of_hash.pop(digest, None)
                self.evictions += 1
            self._refcount[page] = 1
            taken.append(page)
        return taken

    def release(self, pages: Sequence[int]):
        """Drop one reference per page. A page at refcount 0 returns to the
        free list — unless it is a registered prefix page, which stays CACHED
        (content intact, LRU-evictable) for the next shared-prompt hit.

        Processed in REVERSE caller order: callers pass a slot's pages in
        chain order (prefix head first), so the reversal hands the chain TAIL
        the oldest LRU tick. Under pool pressure eviction then trims cached
        prefixes from the deep end — the next same-prefix request still
        matches the surviving head pages — instead of evicting the head and
        making every deeper cached page of the chain unmatchable at once."""
        for page in reversed(list(pages)):
            if page == SCRATCH_PAGE:
                raise ValueError("the scratch page is never reference-counted")
            if self._refcount[page] <= 0:
                raise ValueError(f"release of page {page} with refcount {self._refcount[page]}")
            self._refcount[page] -= 1
            if self._refcount[page] == 0:
                if page in self._hash_of_page:
                    self._tick += 1
                    self._lru[page] = self._tick
                else:
                    self._free.append(page)

    # ------------------------------------------------------------ prefix cache
    def match_prefix(self, hashes: Sequence[str], max_pages: int) -> List[int]:
        """Longest chain of already-cached prefix pages for `hashes` (capped at
        `max_pages`; the engine caps below the full prompt so at least one
        suffix token always runs through the model to produce first-token
        logits). Each matched page is PINNED (+1 refcount) — the caller owns
        the release."""
        matched: List[int] = []
        for digest in list(hashes)[: max(max_pages, 0)]:
            page = self._page_of_hash.get(digest)
            if page is None:
                break
            if self._refcount[page] == 0:
                self._lru.pop(page, None)
            self._refcount[page] += 1
            matched.append(page)
        return matched

    def register_prefix(self, hashes: Sequence[str], pages: Sequence[int], start: int = 0):
        """Attach chain hashes to pages `start..len(hashes)-1` after a
        successful insert wrote them (the first `start` entries were matched,
        already-registered pages). First writer wins: if another request
        registered the same digest concurrently, the later page stays a
        private, unregistered page — content is identical either way."""
        for i in range(start, len(hashes)):
            digest, page = hashes[i], pages[i]
            if page == SCRATCH_PAGE:
                raise ValueError("cannot register the scratch page as a prefix page")
            if digest in self._page_of_hash or page in self._hash_of_page:
                continue
            self._page_of_hash[digest] = page
            self._hash_of_page[page] = digest

    # ---------------------------------------------------------------- recovery
    def reset(self):
        """Blast-radius recovery: the device pool was rebuilt from zeros, so
        every page's CONTENT is gone — drop all refcounts, all prefix
        registrations (a stale hash->page mapping would serve zeroed KV as a
        'cached' prefix), and refill the free list. Cumulative counters
        (`evictions`) survive; they are telemetry, not state."""
        self._init_state()
