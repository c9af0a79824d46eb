"""Router: admission control and least-loaded routing over host workers.

Port of ``pytorch_distributed_tpu/serving/multihost/router.py``. The front
of multihost serving: clients submit
:class:`~pytorch_distributed_tpu_torch.serving.scheduler.Request`\\ s here;
the router finds host workers through the membership log, routes each
request to the least-loaded live host (ties to the lowest channel),
reassembles the sequence-numbered token chunks each worker streams back,
and finishes every request **exactly once**.

Admission looks both ways: a request leaves the pending queue only when a
live host has headroom, counted as the larger of the router's own
outstanding requests there and the occupancy and queue depth the worker
published, so neither a stale snapshot nor a route in flight can
oversubscribe a host. Paged hosts are also sized in pages.

Failover: a host whose load and heartbeat snapshot stops changing for
``heartbeat_ttl_s`` is evicted. Its outbox is drained one last time
(every token it committed is kept); then each of its requests is either
finished here (the committed tokens already meet EOS or the budget) or
re-admitted, at the front of the queue, to a survivor as ``prompt +
committed`` with the rest of its budget. Greedy decoding continues that
prefix as the dead host would have, within floating-point agreement of
the refeed's one prefill with the decode steps that built the same K/V
(exact on the CPU in fp32; on the card compare in fp32 with TF32 off). A
recovered host rejoins by registering again: a new channel, no replay.

Stale streams are fenced by route incarnations (``protocol``): the chunks
of a host declared dead that is only slow no longer match the request's
``route_id`` and are dropped.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from pytorch_distributed_tpu_torch.distributed.store import (
    Store,
    StoreTimeoutError,
)
from pytorch_distributed_tpu_torch.observability import (
    LatencyTracker,
    put_metric,
    record_event,
)
from pytorch_distributed_tpu_torch.serving.multihost import protocol
from pytorch_distributed_tpu_torch.serving.multihost.protocol import Keys
from pytorch_distributed_tpu_torch.serving.scheduler import (
    FinishedRequest,
    Request,
)

__all__ = ["Router"]


class _HostView:
    """The router's view of one worker channel."""

    def __init__(self, msg: dict, now: float):
        self.chan = int(msg["chan"])
        self.host = str(msg["host"])
        self.n_slots = int(msg["n_slots"])
        self.prefill_len = int(msg["prefill_len"])
        self.max_len = int(msg["max_len"])
        self.spec_k = int(msg["spec_k"])
        # > 0: a paged-cache host, sized in pages
        self.page_size = int(msg.get("page_size", 0))
        self.alive = True
        self.out_cursor = 0
        self.outstanding: set = set()
        self.routed_total = 0
        self.hb = -1
        self.last_seen = now
        self.load: dict = {}


class _InFlight:
    """One request from its submit to its one finish."""

    def __init__(self, req: Request, now: float):
        self.request_id = int(req.request_id)
        self.prompt = np.asarray(req.prompt, np.int64).reshape(-1)
        self.max_new_tokens = int(req.max_new_tokens)
        self.eos_token = req.eos_token
        self.submitted_at = now
        self.committed: List[int] = []
        self.chan: Optional[int] = None
        self.route_id: Optional[int] = None
        self.chunk_seq = 0
        self.committed_at_route = 0
        self.ttft_s: Optional[float] = None
        self.rebalances = 0


class Router:
    """The multihost serving front over a :class:`Store` control plane.

    Usage::

        router = Router(store)
        for r in requests:
            router.submit(r)
        finished = router.run(timeout_s=120)   # or step() in a serve loop
        router.stop_hosts()                    # the workers drain and exit

    ``heartbeat_ttl_s`` must exceed the longest stall of a worker's
    scheduler step (a worker cannot publish from inside it): warm the
    engines up before they register.
    """

    def __init__(
        self,
        store: Store,
        *,
        namespace: str = protocol.DEFAULT_NAMESPACE,
        heartbeat_ttl_s: float = 30.0,
        queue_depth: int = 2,
        emit_events: bool = True,
    ):
        self.store = store
        self.keys = Keys(namespace)
        self.heartbeat_ttl_s = float(heartbeat_ttl_s)
        self.queue_depth = int(queue_depth)  # a host's backlog beyond slots
        self.emit_events = emit_events
        self.hosts: Dict[int, _HostView] = {}
        self._member_cursor = 0
        self._pending: Deque[_InFlight] = deque()
        self._inflight: Dict[int, _InFlight] = {}
        self._completed: set = set()
        self._next_id = 0
        self._route_seq = 0
        self.request_latency = LatencyTracker()  # submit -> finished
        self.ttft = LatencyTracker()             # submit -> first chunk
        self.routed = 0
        self.rebalances = 0
        self.evictions = 0
        self.stale_chunks = 0
        self.weight_pushes = 0
        self._weights: Optional[dict] = None  # the latest push, for joiners

    # -- the client's side -------------------------------------------------------
    def submit(self, request: Request) -> int:
        """Put a request in the router's pending queue; returns its id. It
        goes to a host later, when one has headroom: the pending queue is
        the global backpressure buffer."""
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if request.request_id is None:
            request.request_id = self._next_id
        if (request.request_id in self._inflight
                or request.request_id in self._completed):
            raise ValueError(f"duplicate request_id {request.request_id}")
        self._next_id = max(self._next_id, request.request_id + 1)
        inf = _InFlight(request, time.monotonic())
        self._inflight[inf.request_id] = inf
        self._pending.append(inf)
        return inf.request_id

    @property
    def has_work(self) -> bool:
        return bool(self._pending) or bool(self._inflight)

    def step(self) -> List[FinishedRequest]:
        """One control-plane pass: find hosts, take in results, police the
        heartbeats, dispatch the pending queue. Returns the requests that
        finished, in order."""
        finished: List[FinishedRequest] = []
        self._discover_hosts()
        for hv in list(self.hosts.values()):
            if hv.alive:
                self._drain_outbox(hv, finished)
        self._check_heartbeats(finished)
        self._dispatch()
        return finished

    def run(self, *, timeout_s: float = 300.0,
            poll_interval_s: float = 0.002) -> List[FinishedRequest]:
        """Step until every submitted request has finished."""
        deadline = time.monotonic() + timeout_s
        out: List[FinishedRequest] = []
        while self._pending or self._inflight:
            out.extend(self.step())
            if not (self._pending or self._inflight):
                break
            if time.monotonic() > deadline:
                raise StoreTimeoutError(
                    f"router: {len(self._inflight)} request(s) unfinished "
                    f"after {timeout_s}s ({len(self.hosts)} host(s), "
                    f"{sum(h.alive for h in self.hosts.values())} alive)"
                )
            time.sleep(poll_interval_s)
        return out

    def stop_hosts(self) -> None:
        """Tell every known channel to drain and exit."""
        for hv in self.hosts.values():
            self.store.set(self.keys.stop(hv.chan), b"1")

    def push_weights(self, ckpt_dir: str, *,
                     step: Optional[int] = None) -> int:
        """Push a checkpoint to every live worker while serving. Each
        worker takes the message between decode steps, loads the
        checkpoint through its ``param_loader`` (``serving.
        load_gpt2_params`` or ``checkpoint.load_params`` into a copy of
        its model) and swaps it into its scheduler without draining:
        streams in flight go on, and with greedy sampling an equal-valued
        swap changes no token. Hosts that join later get the latest push
        when they are found. Returns the new version."""
        self.weight_pushes += 1
        self._weights = protocol.weights_msg(
            self.weight_pushes, str(ckpt_dir), step
        )
        payload = protocol.dumps(self._weights)
        for hv in self.hosts.values():
            if hv.alive:
                self.store.set(self.keys.weights(hv.chan), payload)
        if self.emit_events:
            record_event(
                "serving.weight_push", source="router",
                version=self.weight_pushes, ckpt_dir=str(ckpt_dir),
                step=step,
                hosts=sum(h.alive for h in self.hosts.values()),
            )
        put_metric("serving.weight_pushes")
        return self.weight_pushes

    # -- membership and health -------------------------------------------------
    def _discover_hosts(self) -> None:
        while True:
            raw = self.store.get_nowait(self.keys.member(self._member_cursor))
            if raw is None:
                return
            self._member_cursor += 1
            hv = _HostView(protocol.loads(raw), time.monotonic())
            self.hosts[hv.chan] = hv
            if self._weights is not None:
                # a late joiner serves the latest pushed weights
                self.store.set(
                    self.keys.weights(hv.chan), protocol.dumps(self._weights)
                )
            if self.emit_events:
                record_event(
                    "serving.host_join", source="router", host=hv.host,
                    chan=hv.chan, n_slots=hv.n_slots,
                )

    def _check_heartbeats(self, finished: List[FinishedRequest]) -> None:
        now = time.monotonic()
        for hv in list(self.hosts.values()):
            if not hv.alive:
                continue
            raw = self.store.get_nowait(self.keys.load(hv.chan))
            if raw is not None:
                m = protocol.loads(raw)
                if m["hb"] != hv.hb:
                    hv.hb = m["hb"]
                    hv.last_seen = now
                hv.load = m
            if now - hv.last_seen > self.heartbeat_ttl_s:
                self._evict_host(hv, finished)

    def _evict_host(self, hv: _HostView,
                    finished: List[FinishedRequest]) -> None:
        self._drain_outbox(hv, finished)    # keep every committed token
        hv.alive = False
        self.evictions += 1
        victims = sorted(rid for rid in hv.outstanding
                         if rid in self._inflight)
        if self.emit_events:
            record_event(
                "serving.host_evict", source="router", host=hv.host,
                chan=hv.chan, reason="heartbeat_ttl", in_flight=len(victims),
            )
        put_metric("serving.host_evictions")
        readmit: List[_InFlight] = []
        for rid in victims:
            inf = self._inflight[rid]
            if self._finish_if_satisfied(inf, finished):
                continue
            # fence the old route and requeue at the FRONT: re-admitted
            # work takes the freed capacity before fresh admissions
            inf.route_id = None
            from_chan = inf.chan
            inf.chan = None
            inf.rebalances += 1
            self.rebalances += 1
            readmit.append(inf)
            if self.emit_events:
                record_event(
                    "serving.rebalance", source="router",
                    request_id=rid, from_host=hv.host,
                    from_chan=from_chan,
                    committed=len(inf.committed),
                )
        hv.outstanding.clear()
        self._pending.extendleft(reversed(readmit))

    def _finish_if_satisfied(self, inf: _InFlight,
                             finished: List[FinishedRequest]) -> bool:
        """The committed prefix may meet a finish condition already (the
        host died between committing its last token and publishing its
        finish)."""
        if inf.eos_token is not None and inf.eos_token in inf.committed:
            cut = inf.committed.index(inf.eos_token) + 1
            inf.committed = inf.committed[:cut]
            self._finish(inf, "eos", finished)
            return True
        if len(inf.committed) >= inf.max_new_tokens:
            self._finish(inf, "length", finished)
            return True
        return False

    # -- results ---------------------------------------------------------------------
    def _drain_outbox(self, hv: _HostView,
                      finished: List[FinishedRequest]) -> None:
        while True:
            key = self.keys.outbox(hv.chan, hv.out_cursor)
            raw = self.store.get_nowait(key)
            if raw is None:
                return
            self.store.delete_key(key)
            hv.out_cursor += 1
            self._ingest(hv, protocol.loads(raw), finished)

    def _ingest(self, hv: _HostView, msg: dict,
                finished: List[FinishedRequest]) -> None:
        rid = int(msg["request_id"])
        inf = self._inflight.get(rid)
        if inf is None or msg["route_id"] != inf.route_id:
            self.stale_chunks += 1  # fenced: an old incarnation's stream
            return
        if msg["seq"] != inf.chunk_seq:
            raise RuntimeError(
                f"multihost protocol error: request {rid} expected chunk "
                f"seq {inf.chunk_seq}, got {msg['seq']} from {hv.host}"
            )
        inf.chunk_seq += 1
        if msg["type"] == "tokens":
            if inf.ttft_s is None:
                inf.ttft_s = time.monotonic() - inf.submitted_at
                self.ttft.add(inf.ttft_s)
            inf.committed.extend(int(t) for t in msg["tokens"])
        elif msg["type"] == "finished":
            got = len(inf.committed) - inf.committed_at_route
            if msg["reason"] != "rejected" and got != int(msg["n_tokens"]):
                raise RuntimeError(
                    f"multihost protocol error: request {rid} finished with "
                    f"{msg['n_tokens']} tokens on {hv.host} but router "
                    f"reassembled {got}"
                )
            hv.outstanding.discard(rid)
            self._finish(inf, msg["reason"], finished)
        else:
            raise RuntimeError(f"unknown outbox message type {msg['type']!r}")

    def _finish(self, inf: _InFlight, reason: str,
                finished: List[FinishedRequest]) -> None:
        total = time.monotonic() - inf.submitted_at
        fin = FinishedRequest(
            request_id=inf.request_id,
            prompt=inf.prompt,
            tokens=list(inf.committed),
            reason=reason,
            ttft_s=inf.ttft_s if inf.ttft_s is not None else total,
            total_s=total,
        )
        del self._inflight[inf.request_id]
        self._completed.add(inf.request_id)
        self.request_latency.add(total)
        put_metric("serving.router_finished")
        finished.append(fin)

    # -- dispatch ----------------------------------------------------------------------
    def _effective_load(self, hv: _HostView) -> int:
        published = hv.load.get("active", 0) + hv.load.get("queued", 0)
        return max(len(hv.outstanding), published)

    def _fits(self, inf: _InFlight, hv: _HostView) -> bool:
        refeed_len = inf.prompt.shape[0] + len(inf.committed)
        return refeed_len <= hv.prefill_len and refeed_len < hv.max_len

    def _page_headroom(self, inf: _InFlight, hv: _HostView) -> bool:
        """Pages for a paged host: the request's worst-case span (refeed,
        the rest of its budget and the speculative margin, capped at
        ``max_len``) must fit the host's published free pages, less the
        same worst case for every request routed there that the snapshot
        cannot show yet. Slotted hosts (and snapshots without the field)
        take the slot count alone."""
        fp = hv.load.get("free_pages", -1)
        if hv.page_size <= 0 or fp < 0:
            return True
        span = min(
            inf.prompt.shape[0] + len(inf.committed)
            + (inf.max_new_tokens - len(inf.committed)) + hv.spec_k,
            hv.max_len,
        )
        need = -(-span // hv.page_size)
        published = hv.load.get("active", 0) + hv.load.get("queued", 0)
        unseen = max(0, len(hv.outstanding) - published)
        return fp - unseen * need >= need

    def _dispatch(self) -> None:
        while self._pending:
            live = [hv for hv in self.hosts.values() if hv.alive]
            if not live:
                return
            inf = self._pending[0]
            fitting = [hv for hv in live if self._fits(inf, hv)]
            if not fitting:
                raise RuntimeError(
                    f"request {inf.request_id}: prompt+committed length "
                    f"{inf.prompt.shape[0] + len(inf.committed)} exceeds "
                    f"every live host's prefill window"
                )
            ready = [
                hv for hv in fitting
                if self._effective_load(hv) < hv.n_slots + self.queue_depth
                and self._page_headroom(inf, hv)
            ]
            if not ready:
                return  # backpressure: every fitting host is full
            hv = min(ready, key=lambda h: (self._effective_load(h), h.chan))
            self._pending.popleft()
            self._route(inf, hv)

    def _route(self, inf: _InFlight, hv: _HostView) -> None:
        inf.chan = hv.chan
        inf.route_id = self._route_seq
        self._route_seq += 1
        inf.chunk_seq = 0
        inf.committed_at_route = len(inf.committed)
        refeed = [int(t) for t in inf.prompt] + list(inf.committed)
        remaining = inf.max_new_tokens - len(inf.committed)
        n = self.store.add(self.keys.in_seq(hv.chan), 1) - 1
        self.store.set(
            self.keys.inbox(hv.chan, n),
            protocol.dumps(protocol.wire_request(
                inf.request_id, inf.route_id, refeed, remaining,
                inf.eos_token,
            )),
        )
        hv.outstanding.add(inf.request_id)
        hv.routed_total += 1
        self.routed += 1
        if self.emit_events:
            record_event(
                "serving.route", source="router",
                request_id=inf.request_id, host=hv.host, chan=hv.chan,
                route_id=inf.route_id, prompt_len=len(refeed),
                max_new_tokens=remaining,
                refeed=inf.committed_at_route > 0,
            )

    # -- stats -----------------------------------------------------------------------
    def stats(self) -> dict:
        """The router's aggregates: hosts, routes, rebalances, evictions,
        fenced chunks, weight pushes, request and TTFT percentiles, routes
        and free pages per host, and the speculative accept rate summed
        over the hosts."""
        lat = self.request_latency.summary()
        out = {
            "hosts": len(self.hosts),
            "hosts_alive": sum(h.alive for h in self.hosts.values()),
            "routed": self.routed,
            "rebalances": self.rebalances,
            "evictions": self.evictions,
            "stale_chunks": self.stale_chunks,
            "weight_pushes": self.weight_pushes,
            "weights_version_min": min(
                (hv.load.get("weights_version", 0)
                 for hv in self.hosts.values() if hv.alive),
                default=0,
            ),
            "request_p50_s": lat["p50_s"],
            "request_p99_s": lat["p99_s"],
            "ttft_p50_s": self.ttft.percentile(50),
            "ttft_p99_s": self.ttft.percentile(99),
            "per_host_routed": {
                hv.host: hv.routed_total for hv in self.hosts.values()
            },
            "free_pages": {
                hv.host: hv.load["free_pages"]
                for hv in self.hosts.values()
                if hv.alive and hv.load.get("free_pages", -1) >= 0
            },
        }
        num = sum(hv.load.get("accept_num", 0) for hv in self.hosts.values())
        den = sum(hv.load.get("accept_den", 0) for hv in self.hosts.values())
        if den:
            out["accept_rate"] = num / den
            out["per_host_accept_rate"] = {
                hv.host: hv.load["accept_num"] / hv.load["accept_den"]
                for hv in self.hosts.values()
                if hv.load.get("accept_den")
            }
        return out
