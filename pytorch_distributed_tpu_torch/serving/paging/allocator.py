"""Host-side page allocator: free list, refcounts, reservations, COW.

The control-plane half of the paged cache. Pages are plain integers into
the ``PagedKVCache`` pools; this object owns which sequence (and the radix
tree) may reference each page:

* **free list** — LIFO stack of unreferenced page ids. Page 0 (the trash
  page) is never in it.
* **refcounts** — a page is freed when its count hits zero. A live
  sequence holds one reference per table entry; the radix tree pins prompt
  pages with its own reference so they survive eviction.
* **copy-on-write** — writes are only legal in pages the writer owns
  exclusively. Before a write would land in a shared page
  (``refcount > 1``) the scheduler calls :meth:`cow`, which re-points the
  slot's table entry at a fresh page and reports the (src, dst) pair so
  the device copy (``kv_cache.fork_pages``) can run.
* **reservations** — admission reserves the sequence's worst-case page
  count up front (prompt + generation budget, rounded to pages), so a
  sequence that was admitted can always grow its chain: ``alloc`` draws
  down the slot's credit and admission only succeeds while
  ``free - outstanding reservations`` covers the newcomer. Pages released
  early (spec-decode rollback of a rejected span) refund their credit.

The allocator mirrors the block tables as a numpy array; the scheduler
copies the mirror into the device block tables when it changes (``tables``
/ ``dirty``). Everything here is host Python and numpy, so admission
decisions never touch the device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["CapacityError", "PageAllocator"]

TRASH_PAGE = 0


class CapacityError(RuntimeError):
    """Raised when a page allocation cannot be satisfied."""


class PageAllocator:
    def __init__(self, *, n_pages: int, page_size: int, n_slots: int,
                 max_pages: int):
        if n_pages < 2:
            raise ValueError("n_pages must be >= 2 (page 0 is reserved)")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.n_slots = int(n_slots)
        self.max_pages = int(max_pages)
        # LIFO: recently freed pages are re-used first (warm in cache)
        self._free: List[int] = list(range(1, n_pages))
        self.refcount = np.zeros(n_pages, np.int64)
        self.refcount[TRASH_PAGE] = 1  # never allocatable
        self.tables = np.zeros((n_slots, max_pages), np.int32)
        self.chain_len = np.zeros(n_slots, np.int64)  # table entries in use
        self.reserved = np.zeros(n_slots, np.int64)   # undrawn credit
        self.dirty = False  # device block_tables out of date

    # -- capacity ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        """Physically free pages right now."""
        return len(self._free)

    @property
    def available_pages(self) -> int:
        """Free pages not spoken for by outstanding reservations — what a
        new admission may claim without endangering live sequences."""
        return len(self._free) - int(self.reserved.sum())

    def pages_for(self, n_positions: int) -> int:
        """Pages needed to cover positions ``0 .. n_positions-1``."""
        return max(0, -(-int(n_positions) // self.page_size))

    # -- refcount primitives ----------------------------------------------
    def pin(self, page: int) -> None:
        """Add a reference (radix tree keeping a prompt page alive)."""
        if page == TRASH_PAGE:
            raise ValueError("cannot pin the trash page")
        if self.refcount[page] <= 0:
            raise ValueError(f"pin of unreferenced page {page}")
        self.refcount[page] += 1

    def deref(self, page: int) -> bool:
        """Drop a reference; returns True when the page went back to the
        free list."""
        if page == TRASH_PAGE:
            raise ValueError("cannot deref the trash page")
        if self.refcount[page] <= 0:
            raise ValueError(f"deref of unreferenced page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(int(page))
            return True
        return False

    def _pop_free(self) -> int:
        if not self._free:
            raise CapacityError("page pool exhausted")
        page = self._free.pop()
        self.refcount[page] = 1
        return page

    # -- admission ---------------------------------------------------------
    def admit(self, slot: int, shared_pages: List[int],
              total_pages: int, *, cow_last: bool = False) -> bool:
        """Attach a radix-matched prefix chain and reserve the rest.

        ``shared_pages`` go into table positions ``0..len-1`` by reference
        (refcount bumped); the reservation covers the remaining
        ``total_pages - len(shared_pages)`` pages the sequence may grow
        into, plus one page when ``cow_last`` (the last shared page holds
        the final prompt token, so the admission prefill will fork it).
        Returns False — attaching nothing — when the pool cannot cover the
        reservation.
        """
        if self.chain_len[slot]:
            raise ValueError(f"slot {slot} already has a chain")
        if total_pages > self.max_pages:
            raise ValueError(
                f"sequence needs {total_pages} pages > table width "
                f"{self.max_pages}"
            )
        need = total_pages - len(shared_pages) + (1 if cow_last else 0)
        if need > self.available_pages:
            return False
        for m, page in enumerate(shared_pages):
            self.pin(page)
            self.tables[slot, m] = page
        self.chain_len[slot] = len(shared_pages)
        self.reserved[slot] = need
        if shared_pages:
            self.dirty = True
        return True

    # -- growth ------------------------------------------------------------
    def alloc(self, slot: int) -> int:
        """Append one fresh page to a slot's chain."""
        m = int(self.chain_len[slot])
        if m >= self.max_pages:
            raise CapacityError(f"slot {slot} chain already at max_pages")
        if self.reserved[slot] <= 0 and self.available_pages <= 0:
            raise CapacityError("no reservation credit and pool exhausted")
        page = self._pop_free()
        if self.reserved[slot] > 0:
            self.reserved[slot] -= 1
        self.tables[slot, m] = page
        self.chain_len[slot] = m + 1
        self.dirty = True
        return page

    def ensure(self, slot: int, n_positions: int) -> None:
        """Grow the chain until it covers positions ``0..n_positions-1``."""
        while self.chain_len[slot] < self.pages_for(n_positions):
            self.alloc(slot)

    def cow(self, slot: int, entry: int) -> Optional[Tuple[int, int]]:
        """Make table entry ``entry`` privately owned before a write.

        Returns ``(src, dst)`` when the page was shared — the caller must
        run the device copy (``fork_pages``) — or None when the page was
        already exclusive.
        """
        src = int(self.tables[slot, entry])
        if src == TRASH_PAGE:
            raise ValueError(f"slot {slot} entry {entry} is unallocated")
        if self.refcount[src] == 1:
            return None
        dst = self._pop_free()
        if self.reserved[slot] > 0:
            self.reserved[slot] -= 1
        self.tables[slot, entry] = dst
        self.refcount[src] -= 1  # never hits 0: it was > 1
        self.dirty = True
        return src, dst

    # -- shrink / teardown -------------------------------------------------
    def release_tail(self, slot: int, n_positions: int) -> List[int]:
        """Return chain pages past the last one covering ``n_positions``
        (rollback of a rejected speculative span). Position ``n_positions``
        is the next write, so its page stays. Refunds reservation credit
        for every entry dropped."""
        keep = min(self.pages_for(n_positions + 1), self.max_pages)
        dropped = []
        for m in range(keep, int(self.chain_len[slot])):
            page = int(self.tables[slot, m])
            self.deref(page)
            self.tables[slot, m] = TRASH_PAGE
            self.reserved[slot] += 1
            dropped.append(page)
        if dropped:
            self.chain_len[slot] = keep
            self.dirty = True
        return dropped

    def free_slot(self, slot: int) -> None:
        """Evict: drop the slot's reference on every chain page (shared
        pages survive via the radix tree's pin), zero the row, void the
        reservation."""
        for m in range(int(self.chain_len[slot])):
            self.deref(int(self.tables[slot, m]))
        if self.chain_len[slot]:
            self.dirty = True
        self.tables[slot] = TRASH_PAGE
        self.chain_len[slot] = 0
        self.reserved[slot] = 0

    def chain(self, slot: int) -> List[int]:
        return [int(p) for p in self.tables[slot, : int(self.chain_len[slot])]]

    def check(self) -> None:
        """Invariant audit (used by tests): every positive-refcount page is
        accounted for by table entries + free list never overlaps."""
        free = set(self._free)
        if TRASH_PAGE in free:
            raise AssertionError("trash page on the free list")
        for slot in range(self.n_slots):
            for page in self.chain(slot):
                if page in free:
                    raise AssertionError(f"live page {page} on free list")
                if self.refcount[page] <= 0:
                    raise AssertionError(f"live page {page} unreferenced")
