"""Inference engine: prefill, decode and speculative steps over the port's
GPT-2.

Port of ``pytorch_distributed_tpu/serving/engine.py``:

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
  * ``spec_decode`` -- speculative decoding (``spec_k > 0``): a draft (the
    first ``draft_layers`` target layers, or a separate small model with
    its own slotted cache) proposes k tokens per slot into cache positions
    past each slot's length, then ONE target forward over the ``[S, k+1]``
    window verifies them and a per-slot prefix is accepted (exact argmax
    match when greedy, leftover sampling otherwise; see
    ``serving.speculative``). ``lengths`` advances by ``accepts + 1``;
    rejected positions keep their K/V bytes, masked and overwritten by the
    next step. On the paged cache the self-draft's one-token forwards and
    the verify window both run the paged-decode kernel.
  * ``swap_params`` -- new weights from any layout, each parameter moved
    onto the engine's own placement by a planned transfer
    (``redistribute``) and written in place between steps.

The JAX engine jits its decode step and both spec steps, one program each.
Here each is a step body over static buffers (``last_tokens``, ``active``
and ``prev_tokens`` of ``[S]``, filled by one host-to-device copy each) and
the cache, updated in place; on the card the body is captured once per
cache object (keyed on its tensors' ``data_ptr``s; the ``Scheduler`` has it
captured when it builds its caches, ``prepare``) as a CUDA graph and each
call is one replay (``_graphs.Program``), on the CPU it runs eagerly. The
programs stay valid across prefills, evictions, table updates and
``swap_params``, which all write in place; a new cache gets a new capture.
The engine warms each body up on a scratch cache when it is built, and
casts the weights to the compute dtype once (``GPT2.cast_weights``). Only
sampled token ids cross to the host each step. Prefill runs eagerly.

Tensor-parallel serving (``cache_sharding``, from
``serving.sharding.kv_cache_sharding`` or ``paged_kv_cache_sharding``):
the model holds this rank's blocks of the weights
(``serving.sharding.shard_gpt2_params`` or ``load_gpt2_params``), the
cache holds its ``H/tp`` heads, and every rank runs the same steps on the
same requests (the all-reduces closing each block keep their hidden
states equal). A step is one graph where every collective in its body can
be captured: on a ``tp`` group over NCCL. Over gloo the same bodies run
eagerly; ``graphs`` says which, decided here from the group's backend.

Parity anchor: with ``SamplingParams(temperature=0)`` the engine, with or
without speculation, emits exactly the argmax of the full uncached forward
at every step.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch._graphs import Program, warm_stream
from pytorch_distributed_tpu_torch.redistribute.plan import (
    LocalMesh,
    Sharding,
    TransferCost,
)
from pytorch_distributed_tpu_torch.serving.kv_cache import KVCache
from pytorch_distributed_tpu_torch.serving.paging import PagedKVCache
from pytorch_distributed_tpu_torch.serving.speculative import (
    DraftConfig,
    draw,
    filtered_probs,
    greedy_accept,
    rejection_accept,
)

__all__ = ["SamplingParams", "InferenceEngine", "SwapCost", "sample_tokens"]


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
    return _sample(logits, generator, sp)[0]


def _sample(logits, generator, sp: SamplingParams):
    """``sample_tokens``, and the filtered distribution the tokens were
    drawn from (None when greedy): a speculative draft's proposal."""
    logits = logits.float()
    if sp.temperature <= 0.0:
        return torch.argmax(logits, dim=-1), None
    probs = filtered_probs(
        logits, temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p
    )
    return draw(probs, generator), probs


#: what ``swap_params`` returns: the planner's cost of the move
SwapCost = TransferCost


def _state_tensors(*caches) -> Tuple[torch.Tensor, ...]:
    """The tensors a step program reads and writes in each cache."""
    return tuple(t for c in caches if c is not None
                 for t in (c.k, c.v, c.lengths,
                           getattr(c, "block_tables", None))
                 if t is not None)


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
    """Prefill/decode/speculative steps over a port ``GPT2`` and a slotted
    or paged cache.

    ``replays`` counts the graph replays of the decode and spec steps (one
    per call on the card, none on the CPU), and ``graphs`` (read-only) is
    whether the steps run as graphs.

    Args:
      model: a ``models.GPT2`` whose parameters live on ``device``; the
        engine keeps compute-dtype copies of its weights
        (``GPT2.cast_weights``), so change its parameters through
        ``swap_params``.
      n_slots: decode batch width (concurrent sequences).
      max_len: per-sequence capacity (prompt + generated); defaults to the
        model's ``n_positions``.
      prefill_len: maximum prompt length.
      prefill_buckets: pad-to lengths for prefill; defaults to powers of two
        up to ``prefill_len``.
      sampling: SamplingParams for every phase.
      cache_dtype: KV dtype (defaults to the model compute dtype).
      seed: seed of the sampling ``torch.Generator``.
      spec_k: speculative-decoding draft depth; 0 disables speculation.
      draft_layers: self-drafting -- the first N target layers (plus
        ``ln_f`` and the tied head) are the draft, sharing the target's
        parameters and cache.
      draft_model / draft_params: a separate small ``models.GPT2`` draft
        sharing the vocab, and the state dict the engine copies into it
        (as ``swap_params`` does). Its own slotted cache
        (:meth:`init_draft_cache`) is threaded by the scheduler beside the
        target cache, whatever ``cache_kind`` is.
      cache_kind: ``"slotted"`` or ``"paged"`` (``serving.paging`` page
        pool + block tables; the scheduler drives the allocator/radix).
      page_size / n_pages: paged-cache geometry; ``n_pages`` defaults to
        slotted-equivalent capacity + the trash page.
      device: ``None`` means the CUDA card (raises without one); pass
        ``"cpu"`` to run the plain versions on the CPU.
      cache_sharding: TP serving: a ``serving.sharding.CacheSharding``
        with the heads on the tp axis of the mesh that ``model`` (and a
        draft model) was cut over; the caches hold ``H/tp`` heads.
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
        if model.cfg.moe_experts > 0:
            raise ValueError("serving supports dense GPT-2 only (MoE "
                             "blocks have no KV-cache story yet)")
        self.device = resolve_device(device)
        self.cache_sharding = cache_sharding
        tp = self._check_tp(cache_sharding, model, draft_model)
        for m in (model, draft_model):
            if m is None:
                continue
            param_device = next(m.parameters()).device
            if param_device.type != self.device.type:
                raise ValueError(
                    f"model parameters live on {param_device}, the engine "
                    f"runs on {self.device}: move the model with .to()"
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

        # -- speculative configuration -------------------------------------
        self.spec_k = int(spec_k)
        self.draft_layers = draft_layers
        self.draft_model = draft_model
        if self.spec_k > 0:
            DraftConfig(
                k=self.spec_k, draft_layers=draft_layers,
                use_draft_model=draft_model is not None,
            ).validate(cfg.n_layer)
            if draft_model is not None:
                if draft_params is None:
                    raise ValueError("draft_model requires draft_params")
                if draft_model.cfg.vocab_size != cfg.vocab_size:
                    raise ValueError(
                        f"draft vocab {draft_model.cfg.vocab_size} != "
                        f"target vocab {cfg.vocab_size} -- the draft must "
                        f"share the tokenizer"
                    )
                if draft_model.cfg.moe_experts > 0:
                    raise ValueError("draft model must be dense")
                self._apply([self._moves(draft_model, draft_params,
                                         "draft")])
            if self.spec_k + 1 >= self.max_len:
                raise ValueError(
                    f"spec_k {self.spec_k} leaves no room in max_len "
                    f"{self.max_len}"
                )
        elif draft_layers is not None or draft_model is not None:
            raise ValueError("draft_layers/draft_model require spec_k >= 1")
        self._spec_steps = 0

        # -- one program per step ------------------------------------------
        for m in (model, draft_model):
            if m is not None:
                m.cast_weights()
        S = self.n_slots
        self._last = torch.zeros(S, dtype=torch.int64, device=self.device)
        self._prev = torch.zeros(S, dtype=torch.int64, device=self.device)
        self._active = torch.zeros(S, dtype=torch.bool, device=self.device)
        # the spec step's draws, seeded anew every round (_seed_spec)
        self._spec_gen = (torch.Generator(device=self.device)
                          if sampling.temperature > 0 and self.spec_k else None)
        self._programs: dict = {}
        self.replays = 0
        # a step's collectives (the tp all-reduces) can be captured only on
        # NCCL; a gloo group runs the bodies eagerly
        self._graphs = self.device.type == "cuda" and (
            tp is None or dist.get_backend(tp.group) == "nccl")
        self._pool = self._stream = None
        if self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = warm_stream(self.device)
            self._warm_up()

    @property
    def graphs(self) -> bool:
        """Whether the decode and spec steps run as CUDA graph replays (on
        the card, unless a tp group's collectives cannot be captured)."""
        return self._graphs

    @staticmethod
    def _check_tp(cache_sharding, model, draft_model):
        """The models' tp context, checked against ``cache_sharding``."""
        tp = getattr(model, "tp", None)
        if cache_sharding is None:
            if tp is not None:
                raise ValueError("a tensor-parallel model needs "
                                 "cache_sharding (its caches hold H/tp "
                                 "heads)")
            return None
        from pytorch_distributed_tpu_torch.serving.sharding import HEAD_DIM

        if set(cache_sharding.dims) != {HEAD_DIM}:
            raise NotImplementedError(
                "cache_sharding: only the heads shard (the dp replicas "
                "serve the same requests); slots on dp are ROADMAP A.15d")
        size = cache_sharding.mesh.size(cache_sharding.tp_axis)
        for m in (model, draft_model):
            if m is None:
                continue
            mtp = getattr(m, "tp", None)
            if mtp is None or mtp.size != size:
                raise ValueError(
                    f"cache_sharding puts the heads on {size} tp ranks: cut "
                    "the model to its blocks first "
                    "(serving.sharding.shard_gpt2_params)")
            if mtp.sequence_parallel:
                raise ValueError("serving runs without sequence parallelism")
        return tp

    def _cache_cfg(self, cfg):
        """``cfg`` with this rank's heads (the cache's shape)."""
        tp = getattr(self.model, "tp", None)
        if tp is None:
            return cfg
        return dataclasses.replace(cfg, n_head=cfg.n_head // tp.size,
                                   n_embd=cfg.n_embd // tp.size)

    # -- state -------------------------------------------------------------
    def init_cache(self):
        """Fresh resident cache of the configured kind."""
        cfg = self._cache_cfg(self.cfg)
        if self.cache_kind == "paged":
            return PagedKVCache.create(
                cfg, n_slots=self.n_slots, max_len=self.max_len,
                page_size=self.page_size, n_pages=self.n_pages,
                dtype=self.cache_dtype, device=self.device,
            )
        return KVCache.create(
            cfg, n_slots=self.n_slots, max_len=self.max_len,
            dtype=self.cache_dtype, device=self.device,
        )

    def init_draft_cache(self) -> Optional[KVCache]:
        """Slotted cache for the separate draft model (None when
        self-drafting or speculation is off: self-drafting shares the target
        cache)."""
        if self.draft_model is None:
            return None
        return KVCache.create(
            self._cache_cfg(self.draft_model.cfg), n_slots=self.n_slots,
            max_len=self.max_len,
            dtype=self.cache_dtype, device=self.device,
        )

    def _moves(self, model, state, what: str):
        """The planned move of ``state`` onto ``model``'s parameters, checked
        (see :meth:`swap_params`): ``(sources, targets, outs)``."""
        from pytorch_distributed_tpu_torch.serving.sharding import (
            _check_sources,
            _Dst,
            _sources,
            _Src,
        )

        sharding = self.cache_sharding
        mesh = sharding.mesh if sharding is not None else LocalMesh(
            self.device)
        tp_axis = sharding.tp_axis if sharding is not None else None
        sources = _sources(state)
        targets, outs = {}, {}
        for name, t in model.state_dict(keep_vars=True).items():
            tp = getattr(t, "tp", None)
            placement = {tp_axis: tp.dim} if tp is not None else {}
            whole = tp.whole if tp is not None else tuple(t.shape)
            targets[name] = _Dst(whole, t.dtype, mesh, placement,
                                 tp.chunks if tp is not None else 1)
            outs[name] = t.detach()
            src = sources.get(name)
            if (tp is not None and src is not None and src.sharding is None
                    and src.shape == tuple(t.shape) != tuple(whole)):
                # a block of the engine's own placement
                sources[name] = _Src(src.x, Sharding.from_placement(
                    mesh, placement, t.dim()), tuple(whole), src.dtype,
                    tp.chunks > 1)
        _check_sources(sources, targets, what)
        return sources, targets, outs

    @staticmethod
    def _apply(moves, max_staging_bytes=None) -> TransferCost:
        from pytorch_distributed_tpu_torch.serving.sharding import (
            _move_params,
        )

        cost = TransferCost(0, 0, 0)
        for sources, targets, outs in moves:
            cost = cost + _move_params(sources, targets, outs=outs,
                                       max_staging_bytes=max_staging_bytes)[1]
        return cost

    def swap_params(self, params, *, draft_params=None,
                    max_staging_bytes: Optional[int] = None) -> TransferCost:
        """Install new weights between steps (reshard-while-serving).

        ``params`` (and ``draft_params`` for a separate draft model) is a
        state dict in the model's own names whose values may have any
        layout: DTensors on any mesh (a trainer's blocks), whole tensors
        or numpy arrays every rank holds, or tensors shaped like this
        rank's blocks (the engine's own placement). Names, whole shapes
        and dtypes must match, and everything is checked before anything
        is copied. Each leaf is moved by the ``redistribute`` planner onto
        the current parameter's placement (its tp block, or whole; the
        fused ``c_attn`` as three leaves) and written into its storage,
        through one staging buffer of at most ``max_staging_bytes`` where
        a leaf crosses rank sets or comes from the host to the card: every
        ``data_ptr`` stays, so the captured step programs stay valid and a
        greedy stream continues token-identically when the new values
        equal the old. Every rank of a tp group calls it, between steps.
        Returns the planner's :class:`TransferCost` of the move.
        """
        if draft_params is not None and self.draft_model is None:
            raise ValueError(
                "swap_params: draft_params given but engine has no separate "
                "draft model"
            )
        moves = [self._moves(self.model, params, "target")]
        if draft_params is not None:
            moves.append(self._moves(self.draft_model, draft_params, "draft"))
        cost = self._apply(moves, max_staging_bytes)
        self.model.cast_weights()
        if draft_params is not None:
            self.draft_model.cast_weights()
        return cost

    # -- step bodies ---------------------------------------------------------
    def _slot_prefill(self, model, cache: KVCache, tokens, slot: int,
                      prompt_len: int):
        """Run ``tokens [1, bucket]`` through ``model`` into one slot of a
        slotted cache (a view of the slot's rows, so compute is O(bucket),
        not O(slots x bucket)); returns the logits ``[1, bucket, V]``."""
        sub = KVCache(
            k=cache.k[:, slot:slot + 1], v=cache.v[:, slot:slot + 1],
            lengths=torch.zeros(1, dtype=torch.int32, device=self.device),
        )
        logits, _ = model(tokens, kv_cache=sub, position_offset=sub.lengths)
        cache.lengths[slot] = prompt_len
        return logits

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

    def _verify_and_commit(self, cache, base, last_tokens, draft, d_probs,
                           active, gen):
        """One target forward over ``[S, k+1]``, prefix acceptance, length
        commit; shared by both draft flavours. ``base`` is a copy of the
        lengths before the draft, not the cache's own tensor (which
        ``advance`` moves in place)."""
        sp = self.sampling
        window = torch.cat([last_tokens[:, None], draft], dim=1)
        logits, _ = self.model(window, kv_cache=cache, position_offset=base,
                               verify=True)
        if sp.temperature <= 0.0:
            accepts, emitted = greedy_accept(logits, draft)
        else:
            t_probs = filtered_probs(logits, temperature=sp.temperature,
                                     top_k=sp.top_k, top_p=sp.top_p)
            accepts, emitted = rejection_accept(
                t_probs, torch.stack(d_probs, dim=1), draft, gen)
        n_emit = torch.where(active, accepts + 1, 0).to(torch.int32)
        # commit: lengths = base + accepts + 1; the rejected tail keeps its
        # speculative K/V bytes, masked and overwritten by the next step
        cache.rollback(base)
        cache.advance(n_emit)
        # the token now at position lengths - 1 (the separate draft's
        # catch-up refeed reads it): the last accepted proposal, or the old
        # last token
        ai = torch.clamp(accepts - 1, min=0)
        prev = torch.gather(draft, 1, ai[:, None])[:, 0]
        prev_next = torch.where(accepts > 0, prev, last_tokens)
        return emitted, n_emit, prev_next

    def _spec_self_fn(self, cache, last_tokens, active, gen):
        """Self-drafting: k truncated forwards into the SAME cache at the
        positions past each length (layers 0..N-1 only, no advance), then
        one full verify that rewrites every drafted position for all
        layers."""
        base = cache.lengths.clone()
        tok = last_tokens
        draft, d_probs = [], []
        for i in range(self.spec_k):
            logits, _ = self.model(tok[:, None], kv_cache=cache,
                                   position_offset=base + i,
                                   n_layers=self.draft_layers)
            tok, probs = _sample(logits[:, 0], gen, self.sampling)
            draft.append(tok)
            d_probs.append(probs)
        return self._verify_and_commit(cache, base, last_tokens,
                                       torch.stack(draft, dim=1), d_probs,
                                       active, gen)

    def _spec_draft_fn(self, cache, dcache, last_tokens, prev_tokens, active,
                       gen):
        """Separate draft model: k draft forwards against the draft's own
        cache. The first is a ``[S, 2]`` catch-up refeed of ``[prev, last]``
        at positions ``len-1, len``: rewriting a cached position is
        idempotent, and after a full accept it fills the one position the
        draft never processed."""
        base = cache.lengths.clone()
        refeed = torch.stack([prev_tokens, last_tokens], dim=1)
        dlogits, _ = self.draft_model(
            refeed, kv_cache=dcache,
            position_offset=torch.clamp(base - 1, min=0))
        tok, probs = _sample(dlogits[:, 1], gen, self.sampling)
        draft, d_probs = [tok], [probs]
        for i in range(1, self.spec_k):
            dlogits, _ = self.draft_model(tok[:, None], kv_cache=dcache,
                                          position_offset=base + i)
            tok, probs = _sample(dlogits[:, 0], gen, self.sampling)
            draft.append(tok)
            d_probs.append(probs)
        out = self._verify_and_commit(cache, base, last_tokens,
                                      torch.stack(draft, dim=1), d_probs,
                                      active, gen)
        # the draft cache is valid through the same accepted prefix
        dcache.rollback(cache.lengths)
        return out

    def _seed_spec(self) -> None:
        """Seed the spec step's generator for one round from the engine
        generator's seed and the step count (where JAX folds the step into
        its key); a greedy round draws nothing."""
        if self._spec_gen is None:
            return
        self._spec_steps += 1
        seed = np.random.SeedSequence(
            [self._gen.initial_seed(), self._spec_steps]
        ).generate_state(1, np.uint64)[0]
        self._spec_gen.manual_seed(int(seed) >> 1)

    # -- programs ----------------------------------------------------------
    def _body(self, kind: str, cache, dcache=None):
        """The step body of ``kind`` (``"decode"`` or ``"spec"``) over
        ``cache`` (and the draft cache) and the static inputs: a function
        of no arguments returning the step's outputs (the tokens ``[S]``;
        for a spec round ``[emitted | count | prev]`` as ``[S, k + 3]``).
        It runs without autograd, whoever calls it (the warm-up, a capture
        or a step), and holds the caches weakly: a program must not keep a
        cache alive."""
        ref = weakref.ref(cache)
        dref = weakref.ref(dcache) if dcache is not None else lambda: None
        last, active, gen = self._last, self._active, self._spec_gen
        if kind == "decode":
            return torch.no_grad()(
                lambda: self._decode_fn(ref(), last, active))

        @torch.no_grad()
        def spec():
            if self.draft_model is None:
                out = self._spec_self_fn(ref(), last, active, gen)
            else:
                out = self._spec_draft_fn(ref(), dref(), last, self._prev,
                                          active, gen)
            emitted, counts, prev_next = out
            return torch.cat([emitted, counts[:, None].long(),
                              prev_next[:, None]], dim=1)
        return spec

    def _program(self, kind: str, cache, dcache=None):
        """The step program of ``kind`` for these caches, built (on the
        card: captured) at the first call with them; dropped when either
        cache object dies."""
        key = (kind,) + tuple(t.data_ptr() for t in
                              _state_tensors(cache, dcache))
        prog = self._programs.get(key)
        if prog is None:
            gens = () if self.sampling.temperature <= 0.0 else (
                self._gen if kind == "decode" else self._spec_gen,)
            prog = Program(self._body(kind, cache, dcache),
                           device=self.device, pool=self._pool,
                           generators=gens, stream=self._stream,
                           capture=self._graphs)
            self._programs[key] = prog
            for c in (cache, dcache):
                if c is not None:
                    weakref.finalize(c, self._programs.pop, key, None)
        return prog

    def prepare(self, cache, draft_cache=None) -> None:
        """Build the step program the scheduler runs on these caches now
        (the spec round with speculation, else the decode step; on the
        card, its capture), so that no step pays for it."""
        self._program("spec" if self.spec_k else "decode", cache, draft_cache)

    def _run(self, kind: str, cache, dcache=None):
        prog = self._program(kind, cache, dcache)
        self.replays += prog.captured
        return prog()

    def _warm_up(self) -> None:
        """Run each step body once on scratch caches, on the capture
        stream, before any capture (cuBLAS, lazily loaded kernels and the
        kernels' first-use build); the sampling generator is left as it
        was."""
        saved = self._gen.get_state()
        with torch.cuda.stream(self._stream):
            cache, dcache = self.init_cache(), self.init_draft_cache()
            self._body("decode", cache)()
            if self.spec_k:
                self._body("spec", cache, dcache)()
        self._gen.set_state(saved)
        torch.cuda.current_stream(self.device).wait_stream(self._stream)

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
            last = self._slot_prefill(self.model, cache, tokens, slot,
                                      n_real)[0, n_real - 1]
        tok = sample_tokens(last[None], self._gen, self.sampling)[0]
        return cache, int(tok)

    @torch.no_grad()
    def prefill_draft(self, draft_cache: KVCache, slot: int,
                      prompt: np.ndarray) -> KVCache:
        """Admit ``prompt`` into the separate draft model's cache (the
        target prefill's bucket; no sampling). Returns the draft cache,
        updated in place."""
        if self.draft_model is None:
            raise RuntimeError("no separate draft model configured")
        padded, n = self._pad_prompt(prompt)
        if not (0 <= slot < self.n_slots):
            raise ValueError(f"slot {slot} out of range")
        self._slot_prefill(self.draft_model, draft_cache,
                           torch.from_numpy(padded).to(self.device), slot, n)
        return draft_cache

    @torch.no_grad()
    def decode(
        self, cache, last_tokens: np.ndarray, active: np.ndarray
    ) -> Tuple[Any, np.ndarray]:
        """One decode step for the whole slot batch.

        ``last_tokens [S]``: each active slot's most recent token;
        ``active [S]`` bool. Returns the cache (updated in place) and the
        sampled tokens ``[S]`` (garbage at inactive slots)."""
        self._fill(self._last, last_tokens, np.int64)
        self._fill(self._active, active, bool)
        toks = self._run("decode", cache)
        return cache, toks.cpu().numpy()

    @staticmethod
    def _fill(static: torch.Tensor, values, dtype) -> None:
        """One host-to-device copy of ``values`` into a static input."""
        static.copy_(torch.from_numpy(np.ascontiguousarray(values, dtype)),
                     non_blocking=True)

    @torch.no_grad()
    def spec_decode(
        self,
        cache,
        draft_cache: Optional[KVCache],
        last_tokens: np.ndarray,
        prev_tokens: np.ndarray,
        active: np.ndarray,
    ) -> Tuple[Any, Optional[KVCache], np.ndarray, np.ndarray, np.ndarray]:
        """One speculative step: draft k, verify once, accept a prefix.

        Returns ``(cache, draft_cache, emitted [S, k+1], counts [S],
        prev_tokens [S])``, the caches updated in place. Each active slot
        emitted ``counts[slot]`` tokens (1..k+1): read
        ``emitted[slot, :counts[slot]]``; entries past the count are
        garbage. ``counts - 1`` is the per-slot accepted draft count.
        ``prev_tokens`` is the token now at ``lengths - 1`` (thread it back
        into the next call; only the separate draft's catch-up reads it)."""
        if self.spec_k <= 0:
            raise RuntimeError("spec_k=0 -- speculative decoding disabled")
        self._fill(self._last, last_tokens, np.int64)
        self._fill(self._active, active, bool)
        if self.draft_model is not None:
            self._fill(self._prev, prev_tokens, np.int64)
        self._seed_spec()
        # one device-to-host copy for the three results
        host = self._run("spec", cache, draft_cache).cpu().numpy()
        k1 = self.spec_k + 1
        return cache, draft_cache, host[:, :k1], host[:, k1], host[:, k1 + 1]
