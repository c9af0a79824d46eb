"""Speculative decoding math: drafting filters, prefix acceptance, leftover
(rejection) sampling. The engine composes these into its draft/verify step.

Port of ``pytorch_distributed_tpu/serving/speculative.py``. The contract
(Leviathan et al. / Chen et al. speculative sampling):

  * a cheap DRAFT proposes ``k`` tokens per slot (self-drafting through the
    first ``draft_layers`` of the target, or a separate small model sharing
    the vocab);
  * ONE target forward over the ``[S, k+1]`` window ``[last, d_1 .. d_k]``
    scores every proposal plus the bonus position;
  * a per-slot PREFIX of the proposals is accepted: greedy
    (``temperature <= 0``) by exact argmax match, so the stream is token for
    token the non-speculative greedy stream; otherwise ``d_i`` survives with
    probability ``min(1, p_t(d_i) / p_d(d_i))`` and the first rejection is
    replaced by a sample of ``normalize(max(p_t - p_d, 0))``, which makes
    the emitted marginal exactly the target sampling distribution.

Both sides of the accept test see the same filtered distribution, so the
temperature / top-k / top-p pipeline lives here and the engine's
``sample_tokens`` routes through it. Random draws come from an explicit
``torch.Generator`` on the logits' device, and none reads back to the host,
so a step that draws runs inside a captured CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = [
    "DraftConfig",
    "draw",
    "filter_logits",
    "filtered_probs",
    "greedy_accept",
    "rejection_accept",
]


@dataclasses.dataclass(frozen=True)
class DraftConfig:
    """Speculative-decoding configuration: ``k`` tokens drafted per step by
    exactly one draft source.

      * ``draft_layers`` -- self-drafting: the first N target layers (plus
        the target's ``ln_f`` and tied head) are the draft. Their K/V equal
        the target's there, so the draft writes the target's cache and the
        verify pass overwrites every drafted position for all layers.
      * ``use_draft_model`` -- a separate small GPT-2 sharing the vocab,
        with its own slotted cache threaded beside the target's.
    """

    k: int
    draft_layers: Optional[int] = None
    use_draft_model: bool = False

    def validate(self, n_layer: int) -> None:
        if self.k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.k}")
        if self.use_draft_model == (self.draft_layers is not None):
            raise ValueError(
                "exactly one draft source: draft_layers (self-drafting) "
                "or a draft model"
            )
        if self.draft_layers is not None and not (
            1 <= self.draft_layers <= n_layer
        ):
            raise ValueError(
                f"draft_layers {self.draft_layers} must be in "
                f"[1, n_layer={n_layer}]"
            )


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
    """Normalized fp32 probabilities of the filtered distribution: what the
    draft proposal and the target verification both score against."""
    return torch.softmax(
        filter_logits(logits, temperature=temperature, top_k=top_k,
                      top_p=top_p),
        dim=-1,
    )


def draw(probs: torch.Tensor, generator: Optional[torch.Generator]
         ) -> torch.Tensor:
    """One sample per row of ``probs [N, V]`` -> ``[N]`` int64: the argmax
    of ``probs / E`` with ``E`` exponential(1) noise: what
    ``torch.multinomial(probs, 1, generator=generator)`` computes (the same
    tokens from the same generator state), without its validity check,
    which reads back to the host."""
    noise = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / noise, dim=-1)


def greedy_accept(
    target_logits: torch.Tensor, draft_tokens: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-match prefix acceptance for greedy decoding.

    Args:
      target_logits: ``[S, k+1, V]``, the verify forward over
        ``[last, d_1 .. d_k]``.
      draft_tokens: ``[S, k]`` int proposals.

    Returns:
      ``(accepts [S], emitted [S, k+1])``, int64. ``accepts`` counts the
      matching prefix (0..k). An accepted ``d_i`` IS the target argmax at
      position ``i``, so ``emitted`` is the target argmax everywhere; the
      caller consumes ``accepts + 1`` of them.
    """
    tgt = torch.argmax(target_logits.float(), dim=-1)
    k = draft_tokens.shape[1]
    match = (tgt[:, :k] == draft_tokens).long()
    accepts = torch.cumprod(match, dim=1).sum(dim=1)
    return accepts, tgt


def rejection_accept(
    target_probs: torch.Tensor,
    draft_probs: torch.Tensor,
    draft_tokens: torch.Tensor,
    generator: Optional[torch.Generator],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative (leftover) sampling acceptance.

    Args:
      target_probs: ``[S, k+1, V]`` filtered target distribution at every
        verify position.
      draft_probs: ``[S, k, V]`` filtered draft distribution each proposal
        was drawn from.
      draft_tokens: ``[S, k]`` int proposals.
      generator: draws the accept uniforms, then the leftover sample; it
        lives on the probabilities' device.

    Returns:
      ``(accepts [S], emitted [S, k+1])``, int64; entries past ``accepts``
      in ``emitted`` are garbage the caller masks with the count. Position
      ``accepts`` holds the leftover sample (on full acceptance the bonus
      token from the target's k-th distribution: the leftover reduces to
      exactly that, since the padded draft probability is zero there).
    """
    S, kp1, V = target_probs.shape
    k = kp1 - 1
    dev = target_probs.device
    draft_tokens = draft_tokens.long()
    u = torch.rand((S, k), generator=generator, device=dev)
    pt_d = torch.gather(target_probs[:, :k], -1, draft_tokens[..., None])[..., 0]
    pd_d = torch.gather(draft_probs, -1, draft_tokens[..., None])[..., 0]
    ok = u * torch.clamp(pd_d, min=1e-20) < pt_d
    accepts = torch.cumprod(ok.long(), dim=1).sum(dim=1)

    # leftover distribution at the first rejected position; past the end
    # (full accept) the draft is padded with zeros, so the leftover IS p_t[k]
    pd_ext = torch.cat(
        [draft_probs, torch.zeros((S, 1, V), dtype=draft_probs.dtype,
                                  device=dev)], dim=1)
    rows = torch.arange(S, device=dev)
    pt_a = target_probs[rows, accepts]
    pd_a = pd_ext[rows, accepts]
    leftover = torch.clamp(pt_a - pd_a, min=0.0)
    mass = leftover.sum(dim=-1, keepdim=True)
    # degenerate leftover (p_t == p_d up to float dust): fall back to p_t;
    # there the two distributions agree, so the choice is unbiased
    leftover = torch.where(mass > 1e-9, leftover / mass, pt_a)
    fix = draw(leftover, generator)

    padded = torch.cat(
        [draft_tokens, torch.zeros((S, 1), dtype=torch.long, device=dev)],
        dim=1)
    pos = torch.arange(k + 1, device=dev)[None]
    emitted = torch.where(pos == accepts[:, None], fix[:, None], padded)
    return accepts, emitted
