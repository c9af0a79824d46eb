"""Dense attention over a preallocated slotted KV cache (plain torch).

Port of ``pytorch_distributed_tpu/ops/decode_attention.py``: queries for
the T new tokens of each sequence attend over that sequence's whole cache
slot, with a position mask. Prefill (T = padded prompt length) and decode
(T = 1) share this one op.

Masking invariant: a query at global position p attends exactly the cache
positions <= p, all written by the slot's current occupant, so slots are
reused without zeroing.

The op reads nothing back to the host, so it runs inside a captured CUDA
graph: writes past the slot are dropped by index arithmetic, not by a
boolean mask (whose indexing would wait for the device).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["attention_scale", "cached_attention"]


def attention_scale(D: int, dtype: torch.dtype) -> float:
    """``1 / sqrt(D)`` rounded to ``dtype``, as the reference computes it,
    as a Python number (a device tensor would be a host-to-device copy)."""
    return (1.0 / torch.sqrt(torch.tensor(float(D))).to(dtype)).item()


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
        drops it (a speculative window near the end of a slot); T <= S.
      position_offset: ``[B]`` int32 global position of each sequence's
        first new token.

    Returns:
      ``(out [B, T, H, D], k_cache, v_cache)``.
    """
    B, T, H, D = q.shape
    S = k_cache.shape[1]
    if T > S:
        raise ValueError(f"{T} new tokens do not fit a slot of {S}")
    pos = position_offset.long()[:, None] + torch.arange(T, device=q.device)
    b_idx = torch.arange(B, device=q.device)[:, None].expand(B, T)
    # A dropped write (pos >= S) goes to the row just before the window
    # instead, with that row's own bytes: the kept positions of a row run
    # from its offset up to S - 1, so that row is not written otherwise
    # (every dropped write of a row carries the same bytes).
    keep = (pos < S)[..., None, None]
    dst = torch.where(pos < S, pos, (pos[:, :1] - 1).clamp(0, S - 1))
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[b_idx, dst] = torch.where(keep, new.to(cache.dtype),
                                        cache[b_idx, dst])

    scale = attention_scale(D, q.dtype)
    scores = torch.einsum("bthd,bshd->bhts", q, k_cache.to(q.dtype)) * scale
    visible = torch.arange(S, device=q.device)[None, None, :] <= pos[:, :, None]
    scores = scores.masked_fill(
        ~visible[:, None], torch.finfo(scores.dtype).min
    )
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs, v_cache.to(q.dtype))
    return out, k_cache, v_cache
