"""Dense attention over a preallocated slotted KV cache (plain torch).

Port of ``pytorch_distributed_tpu/ops/decode_attention.py``: queries for
the T new tokens of each sequence attend over that sequence's whole cache
slot, with a position mask. Prefill (T = padded prompt length) and decode
(T = 1) share this one op.

Masking invariant: a query at global position p attends exactly the cache
positions <= p, all written by the slot's current occupant, so slots are
reused without zeroing.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["cached_attention"]


def cached_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    position_offset: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write ``k_new``/``v_new`` into the cache in place, attend over it.

    Args:
      q, k_new, v_new: ``[B, T, H, D]`` projections for the T new tokens.
      k_cache, v_cache: ``[B, S, H, D]`` per-slot cache, updated in place.
        A write at a position ``>= S`` is dropped, as JAX's ``.at[].set``
        drops it (a speculative window near the end of a slot).
      position_offset: ``[B]`` int32 global position of each sequence's
        first new token.

    Returns:
      ``(out [B, T, H, D], k_cache, v_cache)``.
    """
    B, T, H, D = q.shape
    S = k_cache.shape[1]
    pos = position_offset.long()[:, None] + torch.arange(T, device=q.device)
    b_idx = torch.arange(B, device=q.device)[:, None].expand(B, T)
    keep = pos < S
    k_cache[b_idx[keep], pos[keep]] = k_new[keep].to(k_cache.dtype)
    v_cache[b_idx[keep], pos[keep]] = v_new[keep].to(v_cache.dtype)

    scale = 1.0 / torch.sqrt(torch.tensor(float(D))).to(q.dtype)
    scores = torch.einsum("bthd,bshd->bhts", q, k_cache.to(q.dtype)) * scale
    visible = torch.arange(S, device=q.device)[None, None, :] <= pos[:, :, None]
    scores = scores.masked_fill(
        ~visible[:, None], torch.finfo(scores.dtype).min
    )
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs, v_cache.to(q.dtype))
    return out, k_cache, v_cache
