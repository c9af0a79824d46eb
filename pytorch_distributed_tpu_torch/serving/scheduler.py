"""Continuous batching: per-step join/evict over the engine's slot batch.

Port of ``pytorch_distributed_tpu/serving/scheduler.py``. Requests queue
FIFO, every free slot is filled by a prefill at the top of each step, one
decode step then advances ALL active slots together, and sequences that hit
EOS, their token budget or slot capacity are evicted at iteration
granularity so their slot is reusable on the very next step.

With a speculative engine (``engine.spec_k > 0``) each step consumes
1..k+1 tokens per active slot from one draft + verify round: the accepted
span is scanned for EOS, budget and capacity token by token, as the
one-token path would have, so finish reasons and greedy token streams are
those of non-speculative serving; only the target forwards per token
change. ``swap_params`` installs new weights between steps.

With a paged engine the scheduler also runs the host-side control plane:
the ``PageAllocator`` (reservations, growth, COW) and the ``RadixTree``
(shared-prefix admission); the device only ever sees the resulting block
tables.

Per-request and per-step timings flow into ``observability``: TTFT and
decode-step ``LatencyTracker``s, ``serving.*`` events and metrics.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.observability import (
    LatencyTracker,
    RatioTracker,
    put_metric,
    record_event,
)
from pytorch_distributed_tpu_torch.serving.engine import InferenceEngine
from pytorch_distributed_tpu_torch.serving.paging import (
    PageAllocator,
    RadixTree,
    fork_pages,
)

__all__ = ["Request", "FinishedRequest", "Scheduler"]


@dataclasses.dataclass
class Request:
    """One generation request.

    ``max_new_tokens`` counts generated tokens (the prompt is free);
    ``eos_token`` (if set) stops generation when sampled -- the EOS itself
    is included in the output tokens.
    """

    prompt: Any  # 1-D int sequence
    max_new_tokens: int = 16
    eos_token: Optional[int] = None
    request_id: Optional[int] = None  # assigned by submit()


@dataclasses.dataclass
class FinishedRequest:
    request_id: int
    prompt: np.ndarray
    tokens: List[int]  # generated tokens (includes EOS if hit)
    reason: str  # "eos" | "length"
    ttft_s: float  # prefill submit -> first token
    total_s: float  # prefill submit -> eviction


@dataclasses.dataclass
class _SlotState:
    request: Request
    prompt: np.ndarray
    tokens: List[int]
    admitted_at: float
    ttft_s: float


class Scheduler:
    """Drives an :class:`InferenceEngine` over a FIFO request queue.

    Usage::

        sched = Scheduler(engine)
        for r in requests:
            sched.submit(r)
        finished = sched.run()   # or step() in a serving loop
    """

    def __init__(self, engine: InferenceEngine, *, emit_events: bool = True):
        self.engine = engine
        self.cache = engine.init_cache()
        self.draft_cache = engine.init_draft_cache()
        engine.prepare(self.cache, self.draft_cache)
        self.emit_events = emit_events
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[_SlotState]] = [None] * engine.n_slots
        self.last_tokens = np.zeros((engine.n_slots,), np.int64)
        # token at position lengths-1 per slot (the separate draft's
        # catch-up refeed reads it; harmless otherwise)
        self.prev_tokens = np.zeros((engine.n_slots,), np.int64)
        self.active = np.zeros((engine.n_slots,), bool)
        self.ttft = LatencyTracker()
        self.decode_step = LatencyTracker()  # per decode step (whole batch)
        self.tokens_generated = 0
        self.decode_steps = 0
        self.weight_swaps = 0
        self.accept_rate = RatioTracker()        # accepted / proposed
        self.tokens_per_forward = RatioTracker()  # decode tokens / forwards
        self._next_id = 0
        if engine.cache_kind == "paged":
            self.allocator: Optional[PageAllocator] = PageAllocator(
                n_pages=engine.n_pages, page_size=engine.page_size,
                n_slots=engine.n_slots, max_pages=engine.max_pages,
            )
            self.radix: Optional[RadixTree] = RadixTree(engine.page_size)
        else:
            self.allocator = None
            self.radix = None
        self.prefill_tokens_total = 0   # prompt tokens across admissions
        self.prefill_tokens_cached = 0  # of those, served from the radix

    # -- queue -------------------------------------------------------------
    def submit(self, request: Request) -> int:
        """Enqueue; returns the assigned request id (admission is FIFO)."""
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if request.request_id is None:
            request.request_id = self._next_id
            self._next_id += 1
        else:
            self._next_id = max(self._next_id, request.request_id + 1)
        self.queue.append(request)
        return request.request_id

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def free_pages(self) -> int:
        """Admission capacity in pages, the multihost load snapshot's
        occupancy signal. Paged: the free pages net of outstanding
        reservations. Slotted: the free slots in page-equivalents (each
        slot is ``max_len`` worth of pages), so a router compares the two
        cache kinds on one scale."""
        if self.allocator is not None:
            return int(self.allocator.available_pages)
        return (self.engine.n_slots - self.n_active) * self.engine.max_pages

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    # -- one iteration -----------------------------------------------------
    def step(self) -> List[FinishedRequest]:
        """Admit into free slots, run one decode step, evict finished.

        Returns the requests that completed during this step.
        """
        finished: List[FinishedRequest] = []

        # join: fill every free slot from the queue (lowest slot first so
        # admission order is deterministic for a given free set)
        for slot in range(self.engine.n_slots):
            if not self.queue:
                break
            if self.slots[slot] is not None:
                continue
            plan = None
            if self.allocator is not None:
                plan = self._plan_admission(self.queue[0])
                if plan is None:
                    # page-pool backpressure: the FIFO head can't reserve
                    # its worst-case span -- stop admitting (no head-of-line
                    # skip, so admission order stays deterministic)
                    break
            finished.extend(self._admit(slot, self.queue.popleft(), plan))

        # decode: one token (or a verified speculative span) per active slot
        if self.active.any():
            if self.engine.spec_k > 0:
                finished.extend(self._spec_step())
            else:
                self._grow_chains(spec=False)
                t0 = time.perf_counter()
                self.cache, toks = self.engine.decode(
                    self.cache, self.last_tokens, self.active
                )
                dt = time.perf_counter() - t0
                self.decode_step.add(dt)
                self.decode_steps += 1
                n_act = int(self.active.sum())
                self.tokens_generated += n_act
                self.tokens_per_forward.add(n_act)
                put_metric("serving.tokens_generated", n_act)
                for slot in map(int, np.flatnonzero(self.active)):
                    st = self.slots[slot]
                    tok = int(toks[slot])
                    st.tokens.append(tok)
                    self.last_tokens[slot] = tok
                    finished.extend(self._maybe_finish(slot))
        return finished

    def _spec_step(self) -> List[FinishedRequest]:
        """One speculative round: draft k, verify once, consume the
        accepted span per slot (EOS, budget and capacity checked token by
        token, so finish semantics match the one-token path)."""
        finished: List[FinishedRequest] = []
        k = self.engine.spec_k
        self._grow_chains(spec=True)
        t0 = time.perf_counter()
        (self.cache, self.draft_cache, emitted, counts,
         prev_next) = self.engine.spec_decode(
            self.cache, self.draft_cache, self.last_tokens,
            self.prev_tokens, self.active,
        )
        dt = time.perf_counter() - t0
        self.decode_step.add(dt)
        self.decode_steps += 1
        active_slots = list(map(int, np.flatnonzero(self.active)))
        n_act = len(active_slots)
        accepted = int(counts[self.active].sum()) - n_act
        self.accept_rate.add(accepted, k * n_act)
        put_metric("serving.spec_proposed", k * n_act)
        put_metric("serving.spec_accepted", accepted)
        consumed_total = 0
        step_counts = {}
        for slot in active_slots:
            st = self.slots[slot]
            consumed = 0
            for j in range(int(counts[slot])):
                tok = int(emitted[slot, j])
                st.tokens.append(tok)
                self.last_tokens[slot] = tok
                consumed += 1
                done = self._maybe_finish(slot)
                if done:
                    finished.extend(done)
                    break
            else:
                # survived the whole span: the token at lengths-1 feeds the
                # next draft catch-up
                self.prev_tokens[slot] = int(prev_next[slot])
                if self.allocator is not None:
                    # page-granular rollback: pages taken for the rejected
                    # tail go back to the free list (position
                    # prompt+tokens-1 is the next write; its page stays),
                    # and their reservation credit is refunded
                    new_len = st.prompt.shape[0] + len(st.tokens) - 1
                    self.allocator.release_tail(slot, new_len)
            consumed_total += consumed
            step_counts[slot] = consumed
        self.tokens_generated += consumed_total
        self.tokens_per_forward.add(consumed_total)
        put_metric("serving.tokens_generated", consumed_total)
        if self.emit_events:
            record_event(
                "serving.spec_step", source="scheduler",
                proposed=k * n_act, accepted=accepted,
                consumed=step_counts,
            )
        return finished

    def swap_params(self, params, *, draft_params=None,
                    max_staging_bytes: Optional[int] = None):
        """Reshard-while-serving weight swap, between decode steps.

        Delegates to :meth:`InferenceEngine.swap_params`: the new weights,
        on any layout, are moved by the ``redistribute`` planner onto the
        engine's placement and written in place, so in-flight sequences
        continue without a new capture (token-identically for equal
        values). ``step()`` is synchronous, so any moment outside it is a
        safe swap point. Returns the planner's ``TransferCost``.
        """
        t0 = time.perf_counter()
        cost = self.engine.swap_params(params, draft_params=draft_params,
                                       max_staging_bytes=max_staging_bytes)
        dt = time.perf_counter() - t0
        self.weight_swaps += 1
        if self.emit_events:
            record_event(
                "serving.weight_swap", source="scheduler",
                bytes_moved=cost.bytes_moved, peak_bytes=cost.peak_bytes,
                naive_gather_bytes=cost.naive_gather_bytes,
                duration_s=dt, n_active=self.n_active,
            )
        put_metric("serving.weight_swaps")
        return cost

    def run(self, *, max_steps: Optional[int] = None) -> List[FinishedRequest]:
        """Step until the queue and all slots drain; returns all finished
        requests in completion order."""
        out: List[FinishedRequest] = []
        steps = 0
        while self.has_work:
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return out

    # -- paged-cache internals ---------------------------------------------
    def _span_pages(self, req: Request, prompt_len: int) -> int:
        """Worst-case pages a request can ever touch: prompt + its token
        budget (+ the speculative write margin), capped by max_len."""
        span = prompt_len + req.max_new_tokens + self.engine.spec_k
        return self.allocator.pages_for(min(span, self.engine.max_len))

    def _plan_admission(self, req: Request):
        """Probe whether the FIFO head can reserve its worst-case span
        (reclaiming LRU cached-prefix pages if short). Returns the
        admission plan ``(matched_pages, cached_len, cow_last, span_pages,
        prompt_len)`` or None. The probe does not touch LRU/stats, so
        backpressure retries don't skew them; the touching match runs only
        once the plan is known to fit."""
        alloc = self.allocator
        prompt = np.asarray(req.prompt, np.int64).reshape(-1)
        prompt_len = int(prompt.shape[0])
        span = self._span_pages(req, prompt_len)

        def _need():
            matched = self.radix.match(prompt, touch=False)
            cow = len(matched) * alloc.page_size >= prompt_len
            return matched, span - len(matched) + (1 if cow else 0)

        matched, need = _need()
        short = need - alloc.available_pages
        if short > 0:
            self.radix.reclaim(alloc, short)
            matched, need = _need()  # reclaim may have dropped matched pages
        if need > alloc.available_pages:
            return None
        matched = self.radix.match(prompt)  # LRU touch + hit/miss stats
        cached_len = len(matched) * alloc.page_size
        cow_last = cached_len >= prompt_len
        if cow_last:
            cached_len = prompt_len - 1
        return matched, cached_len, cow_last, span, prompt_len

    def _sync_tables(self) -> None:
        if self.allocator is not None and self.allocator.dirty:
            self.cache.block_tables.copy_(
                torch.from_numpy(self.allocator.tables)
            )
            self.allocator.dirty = False

    def _grow_chains(self, *, spec: bool) -> None:
        """Before a decode/spec step: every active slot's chain must cover
        its write span (the next position, or the k-token speculative
        window). Draws on the slot's admission reservation, so it cannot
        fail."""
        if self.allocator is None:
            return
        margin = self.engine.spec_k if spec else 0
        for slot in map(int, np.flatnonzero(self.active)):
            st = self.slots[slot]
            next_pos = st.prompt.shape[0] + len(st.tokens) - 1
            need = min(next_pos + margin + 1, self.engine.max_len)
            self.allocator.ensure(slot, need)
        self._sync_tables()

    # -- internals ---------------------------------------------------------
    def _admit(self, slot: int, req: Request,
               plan=None) -> List[FinishedRequest]:
        prompt = np.asarray(req.prompt, np.int64).reshape(-1)
        t0 = time.perf_counter()
        cached_len = 0
        if self.allocator is not None:
            if plan is None:
                plan = self._plan_admission(req)
                if plan is None:
                    raise RuntimeError(
                        f"page reservation failed for request "
                        f"{req.request_id}"
                    )
            cached_len = self._attach_pages(slot, plan)
        self.cache, first_tok = self.engine.prefill(
            self.cache, slot, prompt, cached_len=cached_len
        )
        if self.draft_cache is not None:
            # the separate draft's slotted cache has no prefix sharing: it
            # always prefills the whole prompt
            self.draft_cache = self.engine.prefill_draft(
                self.draft_cache, slot, prompt
            )
        if self.radix is not None:
            # cache the prompt's full pages for future admissions (pins
            # them in the allocator so they outlive this sequence)
            self.radix.insert(prompt, self.allocator.chain(slot),
                              self.allocator)
        # token at position lengths-1 == the prompt tail (draft catch-up)
        self.prev_tokens[slot] = int(prompt[-1])
        ttft = time.perf_counter() - t0
        self.ttft.add(ttft)
        self.slots[slot] = _SlotState(
            request=req, prompt=prompt, tokens=[first_tok],
            admitted_at=t0, ttft_s=ttft,
        )
        self.last_tokens[slot] = first_tok
        self.active[slot] = True
        self.tokens_generated += 1
        self.prefill_tokens_total += int(prompt.shape[0])
        self.prefill_tokens_cached += cached_len
        if self.emit_events:
            record_event(
                "serving.admit", source="scheduler",
                request_id=req.request_id, slot=slot,
                prompt_len=int(prompt.shape[0]), ttft_s=ttft,
                cached_len=cached_len,
            )
        # the prefill's own sampled token may already end the request
        return self._maybe_finish(slot)

    def _attach_pages(self, slot: int, plan) -> int:
        """Paged admission: attach the radix-matched chain by reference,
        reserve the worst-case remainder, COW-fork the last page when the
        WHOLE prompt is cached (the final token must still prefill -- its
        logits seed sampling -- and its K/V write may not touch a shared
        page). Returns the cached prefix length."""
        alloc = self.allocator
        matched, cached_len, cow_last, span, prompt_len = plan
        if not alloc.admit(slot, matched, span, cow_last=cow_last):
            raise RuntimeError("page reservation lost between plan and admit")
        if cow_last and matched:
            pair = alloc.cow(slot, len(matched) - 1)
            if pair is not None:
                self.cache = fork_pages(self.cache, pair[0], pair[1])
        # private pages for the uncached tail (reservation-backed)
        alloc.ensure(slot, prompt_len)
        self._sync_tables()
        return cached_len

    def _maybe_finish(self, slot: int) -> List[FinishedRequest]:
        st = self.slots[slot]
        req = st.request
        last = st.tokens[-1]
        reason = None
        if req.eos_token is not None and last == req.eos_token:
            reason = "eos"
        elif len(st.tokens) >= req.max_new_tokens:
            reason = "length"
        # cache capacity: the next decode writes at position
        # prompt_len + len(tokens) - 1, which must stay < max_len
        elif st.prompt.shape[0] + len(st.tokens) - 1 >= self.engine.max_len:
            reason = "length"
        if reason is None:
            return []
        return [self._evict(slot, reason)]

    def _evict(self, slot: int, reason: str) -> FinishedRequest:
        st = self.slots[slot]
        total = time.perf_counter() - st.admitted_at
        if self.allocator is not None:
            # drop the slot's reference on every chain page: private pages
            # go straight back to the free list; radix-pinned prompt pages
            # stay resident for the next same-prefix admission
            self.allocator.free_slot(slot)
        self.engine.evict(self.cache, slot)
        self.slots[slot] = None
        self.active[slot] = False
        fin = FinishedRequest(
            request_id=st.request.request_id,
            prompt=st.prompt,
            tokens=list(st.tokens),
            reason=reason,
            ttft_s=st.ttft_s,
            total_s=total,
        )
        if self.emit_events:
            record_event(
                "serving.request_finished", source="scheduler",
                request_id=fin.request_id, slot=slot, reason=reason,
                prompt_len=int(st.prompt.shape[0]),
                new_tokens=len(fin.tokens),
                ttft_s=fin.ttft_s, total_s=fin.total_s,
            )
        put_metric("serving.requests_finished")
        return fin

    # -- stats -------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Aggregate serving stats. ``tokens_per_target_forward`` counts
        decode-phase tokens over decode/spec steps (prefills excluded):
        without speculation the active-slot average, with it growing toward
        ``1 + accept_rate * spec_k`` per slot. A speculative engine adds
        ``spec_k``, ``accept_rate`` and the draft tokens proposed and
        accepted; ``weight_swaps`` counts ``swap_params`` calls."""
        d = self.decode_step.summary()
        out = {
            "tokens_generated": float(self.tokens_generated),
            "decode_steps": float(self.decode_steps),
            "decode_step_p50_s": d["p50_s"],
            "decode_step_p99_s": d["p99_s"],
            "decode_step_mean_s": d["mean_s"],
            "ttft_p50_s": self.ttft.percentile(50),
            "ttft_p99_s": self.ttft.percentile(99),
            "tokens_per_target_forward": self.tokens_per_forward.rate(),
            "weight_swaps": float(self.weight_swaps),
            "cache_kind": self.engine.cache_kind,
        }
        if self.engine.spec_k > 0:
            out["spec_k"] = float(self.engine.spec_k)
            out["accept_rate"] = self.accept_rate.rate()
            out["spec_proposed"] = float(self.accept_rate.den)
            out["spec_accepted"] = float(self.accept_rate.num)
        if self.allocator is not None:
            out["free_pages"] = float(self.free_pages)
            out["page_size"] = float(self.allocator.page_size)
            out["n_pages"] = float(self.allocator.n_pages)
            out["radix_hits"] = float(self.radix.hits)
            out["radix_misses"] = float(self.radix.misses)
            out["prefill_tokens_total"] = float(self.prefill_tokens_total)
            out["prefill_tokens_cached"] = float(self.prefill_tokens_cached)
        return out
