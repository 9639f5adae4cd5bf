"""Content-hashed prefix index over completed prompt pages (a copy of
``repro.serve.prefix``, logic unchanged).

Maps hash chains over ``page_size`` token-id blocks to physical page ids,
so a request whose prompt starts with an already-served prefix (a system
prompt, a few-shot template) points its page table at existing pages and
prefills only the novel tail. FlashBias makes the sharing total: the
per-page ``pages_phi`` factor slab is position-only, so a cached page
already carries its bias factors.

Host-only: a dict walk over numpy token blocks, no tensor and no device
sync. On a hit nothing moves on the device: sharing is page-table
indirection plus ``PagePool.incref``.

- Chain keys: ``key_i = H(key_{i-1} || block_i)``, so a block's key
  commits to every token before it. A hit is trusted only after a full
  compare of the entry's stored token block (hash-collision safety).
- The index holds its own reference on every registered page, so pages
  stay cached past their request. Index-only pages (refcount 1) are
  evictable: ``evict`` drops least-recently-used LEAF entries, so no entry
  is orphaned behind a missing parent.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.pages import PagePool

__all__ = ["PrefixCache"]

_ROOT = b"prefix-cache-root"


def _blake_chain(parent: bytes, block: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(parent)
    h.update(block)
    return h.digest()


class _Entry:
    __slots__ = ("page", "block", "parent", "children", "last_use")

    def __init__(self, page: int, block: bytes, parent: bytes):
        self.page = page
        self.block = block            # raw int32 bytes: full-compare on hit
        self.parent = parent          # parent chain key (b"" sentinel: root)
        self.children = 0             # live child entries (leaf == 0)
        self.last_use = 0


class PrefixCache:
    """Hash-chain index: completed full prompt pages, keyed by content.

    ``digest`` is injectable so tests can force collisions and prove the
    full token-block compare rejects them.
    """

    def __init__(self, page_size: int,
                 digest: Optional[Callable[[bytes, bytes], bytes]] = None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self._digest = digest or _blake_chain
        self._entries: Dict[bytes, _Entry] = {}
        self._clock = 0               # monotonic touch counter (LRU)
        self.n_evicted = 0
        self.n_rejected = 0           # hash hits rejected by block compare
        self.n_invalidated = 0        # entries dropped by invalidate()

    def __len__(self) -> int:
        return len(self._entries)

    def _blocks(self, tokens: np.ndarray) -> List[bytes]:
        toks = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
        n_full = toks.size // self.page_size
        ps = self.page_size
        return [toks[i * ps:(i + 1) * ps].tobytes() for i in range(n_full)]

    def _touch(self, entry: _Entry) -> None:
        self._clock += 1
        entry.last_use = self._clock

    # ------------------------------------------------------------------
    # Lookup / registration
    # ------------------------------------------------------------------

    def match(self, tokens: np.ndarray) -> Tuple[List[int], int]:
        """Longest indexed prefix of ``tokens`` in whole ``page_size``
        blocks: ``(pages, matched_tokens)``. Matched entries are touched
        so an actively shared prefix never ages to the eviction front."""
        pages: List[int] = []
        key = _ROOT
        for block in self._blocks(tokens):
            key = self._digest(key, block)
            entry = self._entries.get(key)
            if entry is None:
                break
            if entry.block != block:          # hash collision: reject hit
                self.n_rejected += 1
                break
            self._touch(entry)
            pages.append(entry.page)
        return pages, len(pages) * self.page_size

    def insert(self, tokens: np.ndarray, pages: List[int],
               pool: PagePool) -> int:
        """Register the full prompt pages of a landed prompt. Blocks the
        chain already indexes are left pointing at their original page
        (same-wave duplicates keep their private pages — no remap after
        the fact); each NEW entry takes an index reference on its page.
        Returns the number of entries added."""
        added = 0
        key = _ROOT
        for i, block in enumerate(self._blocks(tokens)):
            parent_key, key = key, self._digest(key, block)
            entry = self._entries.get(key)
            if entry is not None:
                if entry.block != block:      # collision: keep old entry
                    self.n_rejected += 1
                    break
                self._touch(entry)
                continue
            entry = _Entry(pages[i], block, parent_key)
            self._touch(entry)
            self._entries[key] = entry
            pool.incref([pages[i]])
            if parent_key != _ROOT:
                self._entries[parent_key].children += 1
            added += 1
        return added

    # ------------------------------------------------------------------
    # Retention / eviction
    # ------------------------------------------------------------------

    def n_cached(self, pool: PagePool) -> int:
        """Pages held ONLY by the index (refcount 1): retained cache."""
        return sum(1 for e in self._entries.values()
                   if pool.refcount(e.page) == 1)

    def n_evictable(self, pool: PagePool) -> int:
        """Pages leaf-first ``evict`` can actually drain under pressure.

        Not every index-only page qualifies: an entry whose DESCENDANT has
        a live sharer (refcount >= 2) is pinned — the descendant is never
        evicted, so the chain above it can never become a leaf. (The state
        arises via copy-on-write: a sharer's table holds private copies of
        some matched pages, referencing only the deepest shared one.) The
        engine's preemption gate keys off this number, so overcounting
        here turns backpressure into a pool-exhaustion crash."""
        pinned = set()
        for entry in self._entries.values():
            if pool.refcount(entry.page) >= 2:
                key = entry.parent
                while key != _ROOT and key not in pinned:
                    pinned.add(key)
                    key = self._entries[key].parent
        return sum(1 for k, e in self._entries.items()
                   if k not in pinned and pool.refcount(e.page) == 1)

    def invalidate(self, pages: List[int], pool: PagePool) -> int:
        """Drop every entry whose page is in ``pages`` — plus ALL its
        descendants — and release the index's reference on each dropped
        page. The quarantine hook: when a slot faults
        (non-finite guard trip), every page it WROTE since admission is
        suspect, and so is every chain entry hanging below one — a chain
        key commits to the tokens, not the content, so a poisoned page
        would keep serving sharers forever if the entry survived.

        Pages a live sharer still holds stay allocated (the decref only
        removes the index's claim) — their content is safe for THOSE
        sharers because copy-on-write means a sharer never writes a page
        it shares; invalidation only stops NEW requests from matching
        entries whose content a faulting slot produced. Returns the
        number of entries dropped."""
        suspect = set(pages)
        doomed = {k for k, e in self._entries.items() if e.page in suspect}
        # descendants: an entry is reachable only through its parent, so
        # anything below a doomed entry must go too (and would otherwise
        # leak its index reference forever)
        changed = True
        while changed:
            changed = False
            for k, e in self._entries.items():
                if k not in doomed and e.parent in doomed:
                    doomed.add(k)
                    changed = True
        for k in doomed:
            entry = self._entries.pop(k)
            if entry.parent != _ROOT and entry.parent in self._entries:
                self._entries[entry.parent].children -= 1
            pool.free([entry.page])
        self.n_invalidated += len(doomed)
        return len(doomed)

    def evict(self, pool: PagePool, need: int) -> int:
        """Drop least-recently-used LEAF entries whose page has no holder
        but the index, until ``need`` pages drained or nothing is left to
        evict. Entries with live sharers (refcount > 1) are never touched.
        Returns the number of pages actually freed."""
        freed = 0
        while freed < need:
            victim_key = None
            victim = None
            for k, e in self._entries.items():
                if e.children == 0 and pool.refcount(e.page) == 1:
                    if victim is None or e.last_use < victim.last_use:
                        victim_key, victim = k, e
            if victim is None:
                break
            del self._entries[victim_key]
            if victim.parent != _ROOT:
                self._entries[victim.parent].children -= 1
            freed += len(pool.free([victim.page]))
            self.n_evicted += 1
        return freed
