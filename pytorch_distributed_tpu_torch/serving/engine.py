"""Inference engine: prefill + decode steps over the port's GPT-2.

Port of ``pytorch_distributed_tpu/serving/engine.py`` without speculative
decoding, TP cache sharding or live weight swaps (ROADMAP A.15):

  * ``prefill`` -- one request's padded prompt ``[1, bucket]`` runs through
    the cache-aware forward into ONE slot of the shared cache, and the first
    generated token is sampled from the last real prompt position. Prompts
    pad to the smallest length bucket (powers of two up to
    ``prefill_len``). On the paged cache a radix prefix hit prefills only
    the uncached tail.
  * ``decode`` -- ``[n_slots, 1]``: every slot advances one token per call
    and only ACTIVE slots' lengths advance (free slots ride along as
    padding, so the batch shape never changes). On the paged cache each
    layer's attention is the CUDA paged-decode kernel.

PyTorch runs eagerly, so the steps are plain methods; the cache is updated
in place and returned for the reference's calling convention. Only sampled
token ids cross to the host each step.

Parity anchor: with ``SamplingParams(temperature=0)`` the engine emits
exactly the argmax of the full uncached forward at every step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.serving.kv_cache import KVCache
from pytorch_distributed_tpu_torch.serving.paging import PagedKVCache
from pytorch_distributed_tpu_torch.serving.speculative import filtered_probs

__all__ = ["SamplingParams", "InferenceEngine", "sample_tokens"]

_NOT_PORTED = "is not ported yet (speculative decoding and TP serving, ROADMAP A.15)"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """``temperature <= 0`` means greedy (argmax); ``top_k=0`` and
    ``top_p=1.0`` disable their filters."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def validate(self) -> None:
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


def sample_tokens(
    logits: torch.Tensor, generator: Optional[torch.Generator],
    sp: SamplingParams,
) -> torch.Tensor:
    """Sample one token per row of ``logits [N, V]`` -> ``[N]`` int64.

    Filter order: temperature, then top-k (exactly k survivors, ties break
    toward lower token ids), then top-p over the filtered distribution.
    Greedy takes the argmax (the first maximal id); otherwise the draw uses
    ``generator``, which lives on the logits' device.
    """
    logits = logits.float()
    if sp.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = filtered_probs(
        logits, temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p
    )
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _default_buckets(prefill_len: int) -> Tuple[int, ...]:
    """Powers of two from 8 up to ``prefill_len`` (inclusive cap)."""
    buckets = []
    b = 8
    while b < prefill_len:
        buckets.append(b)
        b *= 2
    buckets.append(prefill_len)
    return tuple(buckets)


class InferenceEngine:
    """Prefill/decode over a port ``GPT2`` and a slotted or paged cache.

    Args:
      model: a ``models.GPT2`` whose parameters live on ``device``.
      n_slots: decode batch width (concurrent sequences).
      max_len: per-sequence capacity (prompt + generated); defaults to the
        model's ``n_positions``.
      prefill_len: maximum prompt length.
      prefill_buckets: pad-to lengths for prefill; defaults to powers of two
        up to ``prefill_len``.
      sampling: SamplingParams for both phases.
      cache_dtype: KV dtype (defaults to the model compute dtype).
      seed: seed of the sampling ``torch.Generator``.
      cache_kind: ``"slotted"`` or ``"paged"`` (``serving.paging`` page
        pool + block tables; the scheduler drives the allocator/radix).
      page_size / n_pages: paged-cache geometry; ``n_pages`` defaults to
        slotted-equivalent capacity + the trash page.
      device: ``None`` means the CUDA card (raises without one); pass
        ``"cpu"`` to run the plain versions on the CPU.
      cache_sharding, spec_k, draft_layers, draft_model, draft_params: not
        ported yet; anything but the default raises NotImplementedError.
    """

    def __init__(
        self,
        model,
        *,
        n_slots: int = 8,
        max_len: Optional[int] = None,
        prefill_len: Optional[int] = None,
        prefill_buckets: Optional[Sequence[int]] = None,
        sampling: SamplingParams = SamplingParams(),
        cache_dtype: Optional[torch.dtype] = None,
        cache_sharding=None,
        seed: int = 0,
        spec_k: int = 0,
        draft_layers: Optional[int] = None,
        draft_model=None,
        draft_params=None,
        cache_kind: str = "slotted",
        page_size: int = 16,
        n_pages: Optional[int] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if spec_k or draft_layers is not None or draft_model is not None \
                or draft_params is not None:
            raise NotImplementedError(f"speculative decoding {_NOT_PORTED}")
        if cache_sharding is not None:
            raise NotImplementedError(f"cache_sharding {_NOT_PORTED}")
        param_device = next(model.parameters()).device
        if param_device.type != self.device.type:
            raise ValueError(
                f"model parameters live on {param_device}, the engine runs "
                f"on {self.device}: move the model with .to()"
            )
        sampling.validate()
        cfg = model.cfg
        self.model = model
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.max_len = int(max_len or cfg.n_positions)
        self.prefill_len = int(prefill_len or self.max_len)
        if not (0 < self.prefill_len <= self.max_len):
            raise ValueError(
                f"prefill_len {self.prefill_len} must be in "
                f"(0, max_len={self.max_len}]"
            )
        if prefill_buckets is None:
            self.prefill_buckets = _default_buckets(self.prefill_len)
        else:
            buckets = sorted({int(b) for b in prefill_buckets})
            if not buckets or buckets[0] < 1:
                raise ValueError("prefill_buckets must be positive")
            if buckets[-1] > self.prefill_len:
                raise ValueError(
                    f"prefill bucket {buckets[-1]} exceeds prefill_len "
                    f"{self.prefill_len}"
                )
            if buckets[-1] < self.prefill_len:
                buckets.append(self.prefill_len)
            self.prefill_buckets = tuple(buckets)
        self.sampling = sampling
        self.cache_dtype = cache_dtype
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        if cache_kind not in ("slotted", "paged"):
            raise ValueError(
                f"cache_kind must be 'slotted' or 'paged', got {cache_kind!r}"
            )
        self.cache_kind = cache_kind
        self.page_size = int(page_size)
        self.max_pages = -(-self.max_len // self.page_size)
        if n_pages is None and cache_kind == "paged":
            n_pages = self.n_slots * self.max_pages + 1  # + trash page
        self.n_pages = int(n_pages) if n_pages is not None else 0

    # -- state -------------------------------------------------------------
    def init_cache(self):
        """Fresh resident cache of the configured kind."""
        if self.cache_kind == "paged":
            return PagedKVCache.create(
                self.cfg, n_slots=self.n_slots, max_len=self.max_len,
                page_size=self.page_size, n_pages=self.n_pages,
                dtype=self.cache_dtype, device=self.device,
            )
        return KVCache.create(
            self.cfg, n_slots=self.n_slots, max_len=self.max_len,
            dtype=self.cache_dtype, device=self.device,
        )

    def swap_params(self, *args, **kwargs):
        raise NotImplementedError(f"swap_params {_NOT_PORTED}")

    # -- step bodies ---------------------------------------------------------
    def _prefill_fn(self, cache: KVCache, tokens, slot: int, prompt_len: int):
        """Slotted prefill of ``tokens [1, bucket]`` into one slot (a view of
        the slot's rows, so compute is O(bucket), not O(slots x bucket))."""
        sub = KVCache(
            k=cache.k[:, slot:slot + 1], v=cache.v[:, slot:slot + 1],
            lengths=torch.zeros(1, dtype=torch.int32, device=self.device),
        )
        logits, _ = self.model(tokens, kv_cache=sub, position_offset=sub.lengths)
        cache.lengths[slot] = prompt_len
        return logits[0, prompt_len - 1]

    def _paged_prefill_fn(self, cache: PagedKVCache, tokens, slot: int,
                          start: int, n_real: int):
        """Prefill ``tokens [1, bucket]`` (the UNCACHED tail of a prompt)
        into one slot's page chain at global positions ``start..``: a radix
        prefix hit sets ``start = cached_len`` and skips the shared span's
        compute, whose K/V the chain's shared pages supply. B = 1 comes from
        viewing one table row of the shared pools."""
        view = PagedKVCache(
            k=cache.k, v=cache.v,
            block_tables=cache.block_tables[slot:slot + 1],
            lengths=torch.full((1,), start, dtype=torch.int32,
                               device=self.device),
        )
        logits, _ = self.model(tokens, kv_cache=view,
                               position_offset=view.lengths)
        cache.lengths[slot] = start + n_real
        return logits[0, n_real - 1]

    def _decode_fn(self, cache, last_tokens, active):
        logits, _ = self.model(last_tokens[:, None], kv_cache=cache,
                               position_offset=cache.lengths)
        next_tok = sample_tokens(logits[:, 0, :], self._gen, self.sampling)
        # only active slots advance; free slots ride as padding
        cache.advance(1, active)
        return next_tok

    # -- steps -------------------------------------------------------------
    def prefill_bucket(self, n: int) -> int:
        """Smallest prompt bucket holding ``n`` tokens."""
        for b in self.prefill_buckets:
            if b >= n:
                return b
        raise ValueError(
            f"prompt length {n} exceeds prefill_len {self.prefill_len}"
        )

    def _pad_prompt(self, prompt: np.ndarray) -> Tuple[np.ndarray, int]:
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        n = prompt.shape[0]
        if n == 0:
            raise ValueError("empty prompt")
        if n > self.prefill_len:
            raise ValueError(
                f"prompt length {n} exceeds prefill_len {self.prefill_len}"
            )
        if n >= self.max_len:
            raise ValueError(
                f"prompt length {n} leaves no room to generate "
                f"(max_len {self.max_len})"
            )
        padded = np.zeros((1, self.prefill_bucket(n)), np.int64)
        padded[0, :n] = prompt
        return padded, n

    @torch.no_grad()
    def prefill(
        self, cache, slot: int, prompt: np.ndarray, *, cached_len: int = 0
    ) -> Tuple[Any, int]:
        """Admit ``prompt`` (1-D int tokens) into ``slot``; returns the
        cache (updated in place) and the FIRST generated token.

        ``cached_len`` (paged cache only) marks a radix prefix hit: the
        first ``cached_len`` positions are already resident in the slot's
        attached page chain, so only ``prompt[cached_len:]`` is prefilled."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        n = prompt.shape[0]
        cached_len = int(cached_len)
        if cached_len:
            if self.cache_kind != "paged":
                raise ValueError("cached_len requires cache_kind='paged'")
            if not (0 <= cached_len < n):
                raise ValueError(
                    f"cached_len {cached_len} must be in [0, {n})"
                )
            if n > self.prefill_len:
                raise ValueError(
                    f"prompt length {n} exceeds prefill_len "
                    f"{self.prefill_len}"
                )
            if n >= self.max_len:
                raise ValueError(
                    f"prompt length {n} leaves no room to generate "
                    f"(max_len {self.max_len})"
                )
        padded, n_real = self._pad_prompt(prompt[cached_len:])
        if not (0 <= slot < self.n_slots):
            raise ValueError(f"slot {slot} out of range")
        tokens = torch.from_numpy(padded).to(self.device)
        if self.cache_kind == "paged":
            last = self._paged_prefill_fn(cache, tokens, slot, cached_len,
                                          n_real)
        else:
            last = self._prefill_fn(cache, tokens, slot, n_real)
        tok = sample_tokens(last[None], self._gen, self.sampling)[0]
        return cache, int(tok)

    @torch.no_grad()
    def decode(
        self, cache, last_tokens: np.ndarray, active: np.ndarray
    ) -> Tuple[Any, np.ndarray]:
        """One decode step for the whole slot batch.

        ``last_tokens [S]``: each active slot's most recent token;
        ``active [S]`` bool. Returns the cache (updated in place) and the
        sampled tokens ``[S]`` (garbage at inactive slots)."""
        last = torch.as_tensor(np.asarray(last_tokens, np.int64),
                               device=self.device)
        act = torch.as_tensor(np.asarray(active, bool), device=self.device)
        toks = self._decode_fn(cache, last, act)
        return cache, toks.cpu().numpy()
