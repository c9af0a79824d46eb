"""Radix tree over token-hash page chunks — shared-prefix admission cache.

Maps prompt prefixes to the page chains that already hold their K/V, at
page granularity: each node covers one ``page_size``-token chunk, keyed by
the hash of that chunk's token tuple (an exact-match dict — Python tuple
hashing — so collisions cannot alias different prompts). A request whose
prompt walks ``d`` nodes deep admits with those ``d`` pages attached by
reference and only prefills the uncached tail through the existing
power-of-two length buckets.

The tree holds its own refcount pin on every cached page (via
``PageAllocator.pin``), so prompt pages survive the eviction of the
sequence that wrote them — that is the whole point: the *next* request
with the same system prompt skips its prefill. When the pool runs dry the
scheduler calls :meth:`reclaim`, which drops least-recently-used leaves
whose page nobody else references.

Host-side Python only; device bytes never move on a hit — sharing is a
block-table row plus refcounts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["RadixTree"]


class _Node:
    __slots__ = ("key", "page", "children", "parent", "last_use")

    def __init__(self, key, page: int, parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.children: Dict[int, "_Node"] = {}
        self.parent = parent
        self.last_use = 0


class RadixTree:
    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._root = _Node(None, -1, None)
        self._clock = 0
        self.hits = 0          # admissions that matched >= 1 page
        self.misses = 0
        self.cached_tokens = 0  # tokens served from cache across admissions

    def _chunks(self, tokens: Sequence[int]):
        p = self.page_size
        for i in range(len(tokens) // p):
            chunk = tuple(int(t) for t in tokens[i * p : (i + 1) * p])
            yield hash(chunk), chunk

    @property
    def n_nodes(self) -> int:
        def count(node: _Node) -> int:
            return sum(1 + count(c) for c in node.children.values())
        return count(self._root)

    def match(self, tokens: Sequence[int], *, touch: bool = True
              ) -> List[int]:
        """Longest cached prefix of ``tokens``, as a list of page ids (one
        per full page-chunk matched). Touches the matched path for LRU and
        counts hit/miss stats unless ``touch=False`` (a capacity probe)."""
        node = self._root
        pages: List[int] = []
        if touch:
            self._clock += 1
        for key, chunk in self._chunks(tokens):
            child = node.children.get(key)
            if child is None or child.key != chunk:
                break
            if touch:
                child.last_use = self._clock
            pages.append(child.page)
            node = child
        if touch:
            if pages:
                self.hits += 1
                self.cached_tokens += len(pages) * self.page_size
            else:
                self.misses += 1
        return pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               allocator) -> int:
        """Cache the full-page prefix of ``tokens`` backed by ``pages``
        (the sequence's chain, one id per chunk). Existing nodes are kept
        (first writer wins — later identical prompts share the original
        copy); new nodes pin their page in the allocator. Returns the
        number of newly cached pages."""
        self._clock += 1
        node = self._root
        added = 0
        for m, (key, chunk) in enumerate(self._chunks(tokens)):
            if m >= len(pages):
                break
            child = node.children.get(key)
            if child is not None and child.key == chunk:
                child.last_use = self._clock
                node = child
                continue
            if child is not None:  # true hash collision: keep the old entry
                break
            allocator.pin(int(pages[m]))
            child = _Node(chunk, int(pages[m]), node)
            child.last_use = self._clock
            node.children[key] = child
            node = child
            added += 1
        return added

    # -- memory pressure ---------------------------------------------------
    def _leaves(self) -> List[Tuple[int, int, _Node]]:
        out: List[Tuple[int, int, _Node]] = []

        def walk(node: _Node):
            for key, child in node.children.items():
                if child.children:
                    walk(child)
                else:
                    out.append((child.last_use, key, child))

        walk(self._root)
        return out

    def reclaim(self, allocator, n_pages: int) -> int:
        """Drop least-recently-used leaves until ``n_pages`` pages went
        back to the free list. Only leaves whose sole reference is the
        tree's pin are touched — a leaf shared with a live sequence frees
        nothing, so detaching it would destroy future sharing for zero
        pages. Returns pages actually freed."""
        freed = 0
        while freed < n_pages:
            leaves = sorted(self._leaves(), key=lambda t: (t[0], t[1]))
            progressed = False
            for _, key, node in leaves:
                if freed >= n_pages:
                    break
                if allocator.refcount[node.page] != 1:
                    continue
                node.parent.children.pop(key)
                if allocator.deref(node.page):
                    freed += 1
                progressed = True
            if not progressed:
                break  # nothing reclaimable
        return freed

    def clear(self, allocator) -> None:
        """Drop every cached page (tree pins released; pages shared with a
        live sequence free later when that sequence evicts)."""

        def walk(node: _Node):
            for child in node.children.values():
                walk(child)
                allocator.deref(child.page)

        walk(self._root)
        self._root = _Node(None, -1, None)
