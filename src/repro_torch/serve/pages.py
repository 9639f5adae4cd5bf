"""Shared KV page pool for the serve engine: the host-side allocator.

A copy of ``repro.serve.pages.PagePool`` (logic unchanged). The device
cache owns ``n_pages`` pages of ``page_size`` token positions for every
paged cache leaf — K, V and the per-page ``phi_k`` factor slab
(``models/lm.py``); this module is the host side: a free list plus
per-request accounting. Page ids are layout-agnostic.

- Freed pages are handed out lowest-index-first, so page tables are
  deterministic.
- Allocation is lazy by default: admission reserves a prompt's pages and
  the engine ``grow``s a request by one page as its length crosses a page
  boundary; ``n_grown`` counts those, ``watermark`` is the peak number of
  pages in use at once.
- Pages are refcounted (``incref``; ``free`` is a decref that returns the
  pages that drained), so a double free is still caught.
- Failures are typed: exhaustion raises ``PoolExhausted`` (a
  ``MemoryError``), accounting violations ``PoolError``. A failed
  operation never applies, so the pool stays consistent.
"""
from __future__ import annotations

import heapq
from typing import Iterable, List

from repro_torch.serve.lifecycle import PoolError, PoolExhausted

__all__ = ["PagePool"]


class PagePool:
    """Host-side allocator over ``n_pages`` pages of ``page_size`` tokens."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError(f"PagePool needs n_pages >= 1 and "
                             f"page_size >= 1, got ({n_pages}, {page_size})")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages))   # heap, lowest first
        heapq.heapify(self._free)
        self._refs = [0] * n_pages         # holders per page; 0 = free
        self._watermark = 0                # peak pages simultaneously in use
        self._grown = 0                    # pages allocated via grow()

    # -- accounting -----------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def watermark(self) -> int:
        """The most pages ever allocated at once."""
        return self._watermark

    @property
    def n_grown(self) -> int:
        """Pages allocated mid-flight via ``grow`` (vs at admission)."""
        return self._grown

    def pages_needed(self, n_tokens: int) -> int:
        """Pages covering positions ``0 .. n_tokens-1`` (>= 1)."""
        return max(1, -(-int(n_tokens) // self.page_size))

    def can_alloc(self, n: int) -> bool:
        return n <= self.n_free

    def refcount(self, page: int) -> int:
        """Holders of ``page``. 0 = free."""
        self._check_page(page)
        return self._refs[page]

    def _check_page(self, page: int) -> None:
        if not 0 <= page < self.n_pages:
            raise PoolError(f"page id {page} outside pool "
                            f"[0, {self.n_pages})")

    # -- alloc / grow / incref / free -------------------------------------

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages (lowest free indices), all or nothing. Raises
        ``PoolExhausted`` when the pool cannot cover them."""
        if n > self.n_free:
            raise PoolExhausted(
                f"PagePool: want {n} pages, {self.n_free} free")
        pages = [heapq.heappop(self._free) for _ in range(n)]
        for p in pages:
            if self._refs[p] != 0:
                raise PoolError(f"double allocation of page {p}")
            self._refs[p] = 1
        self._watermark = max(self._watermark, self.n_used)
        return pages

    def grow(self, n: int = 1) -> List[int]:
        """``alloc`` for a request already in flight, counted apart from
        admission reservations."""
        pages = self.alloc(n)
        self._grown += n
        return pages

    def incref(self, pages: Iterable[int]) -> None:
        """Add a holder to already-allocated pages (incref of a free page
        is an error)."""
        pages = list(pages)
        for p in pages:
            self._check_page(p)
            if self._refs[p] <= 0:
                raise PoolError(f"incref of free page {p}")
        for p in pages:
            self._refs[p] += 1

    def free(self, pages: Iterable[int]) -> List[int]:
        """Drop one reference per page; pages whose last holder left return
        to the free list, and are returned. Decref of a free page (double
        free) is an error."""
        pages = list(pages)
        for p in pages:
            self._check_page(p)
            if self._refs[p] <= 0:
                raise PoolError(f"double free of page {p}")
        freed: List[int] = []
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                heapq.heappush(self._free, p)
                freed.append(p)
        return freed
