"""Sampling filters shared by ``sample_tokens`` (and, later, speculative
decoding): temperature, exact-k top-k, then top-p.

Port of ``filter_logits``/``filtered_probs`` from
``pytorch_distributed_tpu/serving/speculative.py``. The acceptance math
comes with the speculative-decoding slice.
"""

from __future__ import annotations

import torch

__all__ = ["filter_logits", "filtered_probs"]


def filter_logits(
    logits: torch.Tensor, *, temperature: float, top_k: int, top_p: float
) -> torch.Tensor:
    """Temperature + top-k + top-p filtered fp32 logits ``[..., V]``.

    Filter order matches the HF/vLLM convention. Top-k keeps EXACTLY k
    tokens: ties with the k-th value break toward lower token ids (a stable
    descending sort), never widening the support past k.
    """
    logits = logits.float() / max(temperature, 1e-6)
    neg = torch.finfo(torch.float32).min
    V = logits.shape[-1]
    if 0 < top_k < V:
        idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices
        keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(
            -1, idx[..., :top_k], True)
        logits = torch.where(keep, logits, neg)
    if top_p < 1.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep a token iff the mass BEFORE it is < top_p (the best token
        # always survives, however peaked the distribution)
        keep = (cum - probs) < top_p
        n_keep = keep.sum(dim=-1, keepdim=True)
        kth = torch.gather(desc, -1, n_keep - 1)
        logits = torch.where(logits < kth, neg, logits)
    return logits


def filtered_probs(
    logits: torch.Tensor, *, temperature: float, top_k: int, top_p: float
) -> torch.Tensor:
    """Normalized fp32 probabilities of the filtered distribution."""
    return torch.softmax(
        filter_logits(logits, temperature=temperature, top_k=top_k,
                      top_p=top_p),
        dim=-1,
    )
