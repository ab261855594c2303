"""Host-side page bookkeeping for the block-paged KV arena, the port's own
copy of dtdl_tpu/serve/paged.py (allocator, prefix cache and reset; the spill
tiers and the fleet prefix directory come with a later slice).

* **Page allocation**: a free list over physical pages 1..n_pages-1.  Page
  0 is the reserved garbage page: every unmapped page-table entry points
  at it, and the attend routes inactive rows' writes there, so a stale
  table row never corrupts a live page.
* **Prefix caching**: page i of a prompt is keyed by the chained hash of
  tokens ``[0, (i+1)·page_size)``; a new prompt maps the longest cached
  run read-only (refcounted) and prefills only the suffix.  Hits are
  capped at ``(prompt_len - 1) // page_size`` pages so the write frontier
  is always a private page.  Eviction is LRU over refcount-zero cached
  pages.

Nothing here touches torch: it is policy over integers.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Sequence

GARBAGE_PAGE = 0


def page_chain_hashes(tokens: Sequence[int], page_size: int) -> list[int]:
    """Chained hashes of every FULL page of ``tokens``: entry i keys
    tokens [0, (i+1)·page_size)."""
    out, h = [], 0
    for i in range(len(tokens) // page_size):
        h = hash((h, tuple(int(t)
                           for t in tokens[i * page_size:(i + 1) * page_size])))
        out.append(h)
    return out


class PagePoolExhaustedError(RuntimeError):
    """Every usable page is pinned by a live request (nothing evictable).
    The scheduler turns it into admission backpressure or a named shed."""


class PageAllocator:
    """Free-list page allocator + chained-hash prefix cache.  Page 0 is
    the garbage page and is never allocated."""

    def __init__(self, n_pages: int, page_size: int,
                 prefix_cache: bool = True):
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is the "
                             f"reserved garbage page), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.prefix_cache = prefix_cache
        self._free: deque[int] = deque(range(1, n_pages))
        self._ref: dict[int, int] = {}          # page -> live references
        self._cached: dict[int, int] = {}       # chain hash -> page
        self._page_hash: dict[int, int] = {}    # page -> chain hash
        # refcount-0 cached pages, least-recently-released first
        self._lru: "OrderedDict[int, None]" = OrderedDict()

    @property
    def pages_in_use(self) -> int:
        """Pages referenced by at least one live slot."""
        return len(self._ref)

    @property
    def available(self) -> int:
        """Pages an alloc() could return right now (free + evictable)."""
        return len(self._free) + len(self._lru)

    @property
    def capacity(self) -> int:
        """Usable pages (the pool minus the garbage page)."""
        return self.n_pages - 1

    def alloc(self) -> int:
        """One private page (refcount 1), evicting the LRU refcount-zero
        cached page if the free list is dry."""
        if self._free:
            page = self._free.popleft()
        elif self._lru:
            page, _ = self._lru.popitem(last=False)
            del self._cached[self._page_hash.pop(page)]
        else:
            raise PagePoolExhaustedError(
                f"page pool exhausted: all {self.capacity} pages "
                f"(page_size={self.page_size}) are pinned by live "
                f"requests")
        self._ref[page] = 1
        return page

    def acquire(self, page: int) -> None:
        """Add a reference to a cached page (a prefix hit)."""
        if page not in self._ref:
            self._lru.pop(page, None)        # was evictable; now pinned
            self._ref[page] = 1
        else:
            self._ref[page] += 1

    def release(self, page: int) -> None:
        """Drop one reference; at zero a cached page becomes evictable,
        a private page frees immediately."""
        n = self._ref[page] - 1
        if n > 0:
            self._ref[page] = n
            return
        del self._ref[page]
        if page in self._page_hash:
            self._lru[page] = None           # most-recently released
        else:
            self._free.append(page)

    def reset(self) -> None:
        """Forget everything: every page free, no reference, no cached
        prefix.  Containment calls it after re-initializing the arena, so
        no stale prefix hit can map a page whose contents are gone."""
        self._free = deque(range(1, self.n_pages))
        self._ref.clear()
        self._cached.clear()
        self._page_hash.clear()
        self._lru.clear()

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def page_hashes(self, tokens: Sequence[int]) -> list[int]:
        return page_chain_hashes(tokens, self.page_size)

    def match_prefix(self, prompt: Sequence[int]) -> list[int]:
        """Longest cached run of full prompt pages from page 0, capped at
        ``(len(prompt) - 1) // page_size``; not acquired."""
        if not self.prefix_cache:
            return []
        cap = (len(prompt) - 1) // self.page_size
        pages = []
        for h in self.page_hashes(prompt)[:cap]:
            page = self._cached.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    def register(self, h: int, page: int) -> None:
        """Publish a prefilled full prompt page under its chain hash;
        first writer wins."""
        if not self.prefix_cache or h in self._cached:
            return
        self._cached[h] = page
        self._page_hash[page] = h
