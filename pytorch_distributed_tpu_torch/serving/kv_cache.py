"""Preallocated slotted KV cache, the serving engine's resident state.

Port of ``pytorch_distributed_tpu/serving/kv_cache.py``: ``n_slots``
independent sequence slots, each ``max_len`` tokens deep, for every layer.
``k``/``v`` are ``[L, S, max_len, H, D]`` tensors that live on the device
for the whole session and are updated in place by the cached forward.

Slot lifecycle (driven by ``serving.scheduler``): prefill writes positions
``0..Tpad-1`` of a free slot and sets ``lengths[slot]``; each decode step
writes one token at ``lengths[slot]`` and advances only the active slots;
eviction sets ``lengths[slot] = 0`` and leaves the bytes, which the
``position <= query`` mask makes unreachable.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from pytorch_distributed_tpu_torch._device import resolve_device

__all__ = ["KVCache"]


class KVCache:
    """Per-layer K/V tensors ``[L, S, T, H, D]`` + per-slot ``lengths [S]``
    int32."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor):
        self.k = k
        self.v = v
        self.lengths = lengths

    @classmethod
    def create(
        cls,
        cfg: Any,
        *,
        n_slots: int,
        max_len: int,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ) -> "KVCache":
        """Zero-filled cache for a ``GPT2Config``-shaped model; ``max_len``
        bounds prompt + generated tokens per slot."""
        if max_len > cfg.n_positions:
            raise ValueError(
                f"max_len {max_len} exceeds model n_positions "
                f"{cfg.n_positions}"
            )
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        device = resolve_device(device)
        H, D = cfg.n_head, cfg.n_embd // cfg.n_head
        shape = (cfg.n_layer, n_slots, max_len, H, D)
        dtype = dtype or cfg.dtype
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            lengths=torch.zeros((n_slots,), dtype=torch.int32, device=device),
        )

    def evict(self, slot: int) -> None:
        """Free a slot. K/V bytes stay, masked out."""
        self.lengths[slot] = 0

    def advance(self, n_tokens, active=None) -> None:
        """``lengths += n_tokens`` (``[S]`` or scalar), masked to
        ``active`` slots. The K/V bytes were already written by the cached
        forward; this commits how many of them are real."""
        if active is not None:
            n_tokens = torch.where(active, n_tokens, 0).to(torch.int32)
        self.lengths += n_tokens

    def rollback(self, lengths) -> None:
        """Reset per-slot lengths; positions past them keep their bytes,
        masked and overwritten by the next writes."""
        self.lengths.copy_(torch.as_tensor(lengths, dtype=torch.int32))
