"""Paged KV cache: a pool of fixed-size pages plus per-sequence block tables.

Port of ``pytorch_distributed_tpu/serving/paging/kv_cache.py``. Where the
slotted ``KVCache`` reserves ``max_len`` tokens per slot up front, this
cache holds one shared pool of ``n_pages`` pages of ``page_size`` tokens per
layer: ``k``/``v`` are ``[L, n_pages, page_size, H, D]`` and each slot's
chain of page ids lives in ``block_tables [S, max_pages]`` (table position
``m`` covers global positions ``m*page_size .. (m+1)*page_size-1``).

Page id 0 is the TRASH page: never allocated, never referenced by a live
chain. Evicted slots get an all-zero table row, so the padding-lane writes
of inactive slots land in page 0 and their reads see page 0, masked by the
``position <= query`` rule. Eviction never zeroes K/V bytes: masking plus
page ownership (the allocator's COW discipline) is the isolation boundary.

The tensors live on the device and are updated in place; which pages a
slot may write is host-side state (``PageAllocator``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from pytorch_distributed_tpu_torch._device import resolve_device

__all__ = ["PagedKVCache", "TRASH_PAGE", "fork_pages"]

TRASH_PAGE = 0


class PagedKVCache:
    """Page pools ``[L, P, page, H, D]`` + ``block_tables [S, M]`` int32 +
    per-slot ``lengths [S]`` int32."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 block_tables: torch.Tensor, lengths: torch.Tensor):
        self.k = k
        self.v = v
        self.block_tables = block_tables
        self.lengths = lengths

    @classmethod
    def create(
        cls,
        cfg: Any,
        *,
        n_slots: int,
        max_len: int,
        page_size: int = 16,
        n_pages: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ) -> "PagedKVCache":
        """Zero-filled paged cache for a ``GPT2Config``-shaped model.

        ``n_pages`` defaults to slotted-equivalent capacity (every slot can
        hold ``max_len``) plus the trash page.
        """
        if max_len > cfg.n_positions:
            raise ValueError(
                f"max_len {max_len} exceeds model n_positions "
                f"{cfg.n_positions}"
            )
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        max_pages = -(-max_len // page_size)
        if n_pages is None:
            n_pages = n_slots * max_pages + 1  # + trash page
        if n_pages < 2:
            raise ValueError("n_pages must be >= 2 (page 0 is the trash page)")
        device = resolve_device(device)
        H, D = cfg.n_head, cfg.n_embd // cfg.n_head
        shape = (cfg.n_layer, n_pages, page_size, H, D)
        dtype = dtype or cfg.dtype
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            block_tables=torch.zeros((n_slots, max_pages), dtype=torch.int32,
                                     device=device),
            lengths=torch.zeros((n_slots,), dtype=torch.int32, device=device),
        )

    def evict(self, slot: int) -> None:
        """Free a slot: zero its length AND its table row, so the slot's
        padding-lane writes land in the trash page. K/V bytes stay."""
        self.lengths[slot] = 0
        self.block_tables[slot] = TRASH_PAGE

    def set_table_row(self, slot: int, row) -> None:
        """Install a slot's page chain (host-computed by the allocator)."""
        self.block_tables[slot] = torch.as_tensor(row, dtype=torch.int32)

    def advance(self, n_tokens, active=None) -> None:
        """``lengths += n_tokens`` (``[S]`` or scalar), masked to
        ``active`` slots."""
        if active is not None:
            n_tokens = torch.where(active, n_tokens, 0).to(torch.int32)
        self.lengths += n_tokens

    def rollback(self, lengths) -> None:
        """Reset per-slot lengths. K/V bytes past the new length stay in
        their pages, masked."""
        self.lengths.copy_(torch.as_tensor(lengths, dtype=torch.int32))


def fork_pages(cache: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Copy-on-write fork: duplicate page ``src`` into ``dst`` across all
    layers (K and V), in place. Called before a write would land in a shared
    (refcount > 1) page: the writer re-points its table entry at ``dst`` and
    the shared original stays frozen."""
    cache.k[:, dst] = cache.k[:, src]
    cache.v[:, dst] = cache.v[:, src]
    return cache
