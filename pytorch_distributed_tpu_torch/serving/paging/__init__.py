"""Paged KV cache subsystem: page pool + allocator + radix prefix cache.

* :class:`PagedKVCache` (device) -- ``[L, n_pages, page_size, H, D]`` K/V
  pools + per-slot block tables, updated in place.
* :class:`PageAllocator` (host) -- free list, refcounted copy-on-write
  pages, worst-case admission reservations.
* :class:`RadixTree` (host) -- token-chunk prefix index mapping shared
  prompt prefixes to live page chains.

Selected via ``InferenceEngine(cache_kind="paged")``; the scheduler wires
the three together.
"""

from pytorch_distributed_tpu_torch.serving.paging.allocator import (  # noqa: F401
    CapacityError,
    PageAllocator,
)
from pytorch_distributed_tpu_torch.serving.paging.kv_cache import (  # noqa: F401
    TRASH_PAGE,
    PagedKVCache,
    fork_pages,
)
from pytorch_distributed_tpu_torch.serving.paging.radix import (  # noqa: F401
    RadixTree,
)

__all__ = [
    "CapacityError",
    "PageAllocator",
    "PagedKVCache",
    "RadixTree",
    "TRASH_PAGE",
    "fork_pages",
]
