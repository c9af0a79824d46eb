"""HostWorker: one host's serving loop behind the store's control plane.

Port of ``pytorch_distributed_tpu/serving/multihost/worker.py``. It wraps
the single-host :class:`~pytorch_distributed_tpu_torch.serving.scheduler.
Scheduler` (one a host; the hosts are the dp axis): it drains its
channel's inbox into the scheduler's FIFO queue, runs the continuous-
batching step, streams new tokens back through the outbox in
sequence-numbered chunks, and publishes one load and heartbeat snapshot
every loop, from which the router admits work and declares the host dead
when the snapshot stops changing.

The worker never talks to other workers and never blocks on the store
(every read is ``get_nowait``): a wedged control plane means no new work,
not a stalled decode. It can serve the elastic ``HealthCheckServer``, so
cluster tooling probes serving hosts as it probes training hosts.

On the card a worker cannot publish from inside ``Scheduler.step()``: warm
its engine up (the kernels built, the graphs captured, one request
drained) before :meth:`register`, or the first step can outlast the
router's heartbeat TTL.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from pytorch_distributed_tpu_torch.distributed.store import Store
from pytorch_distributed_tpu_torch.observability import record_event
from pytorch_distributed_tpu_torch.serving.multihost import protocol
from pytorch_distributed_tpu_torch.serving.multihost.protocol import Keys
from pytorch_distributed_tpu_torch.serving.scheduler import Request, Scheduler

__all__ = ["HostWorker"]


class HostWorker:
    """Serve one host's :class:`Scheduler` under a store-coordinated router.

    Args:
      store: any :class:`Store` (``TCPStore`` across hosts, ``HashStore``
        in one process).
      scheduler: the local continuous-batching scheduler.
      host_id: a label for events and reports (the channel comes from
        :meth:`register`: a restarted host keeps its label and gets a new
        channel).
      namespace: the store's key prefix; one namespace is one deployment.
      chunk_tokens: most tokens in one outbox chunk.
      idle_sleep_s: sleep after a loop that found no work.
      health_port: when set, serve an elastic ``HealthCheckServer`` on it
        (0 picks a free port) and beat it every loop.
      param_loader: ``loader(ckpt_dir, step) -> state dict`` for live
        weight pushes (``Router.push_weights``): called when the channel's
        weights key moves past the version served; the state dict it
        returns, in the model's names and on any layout (whole tensors,
        DTensors), goes into ``Scheduler.swap_params`` between decode
        steps, which moves it onto this host's placement in place.
        None ignores pushes.
    """

    def __init__(
        self,
        store: Store,
        scheduler: Scheduler,
        *,
        host_id: str,
        namespace: str = protocol.DEFAULT_NAMESPACE,
        chunk_tokens: int = 16,
        idle_sleep_s: float = 0.002,
        health_port: Optional[int] = None,
        emit_events: bool = True,
        param_loader=None,
    ):
        self.store = store
        self.scheduler = scheduler
        self.host_id = str(host_id)
        self.keys = Keys(namespace)
        self.chunk_tokens = int(chunk_tokens)
        self.idle_sleep_s = float(idle_sleep_s)
        self.emit_events = emit_events
        self.chan: Optional[int] = None
        self._in_cursor = 0
        self._out_seq = 0
        self._hb = 0
        self._sent: Dict[int, int] = {}       # request_id -> tokens flushed
        self._routes: Dict[int, int] = {}     # request_id -> route_id
        self._chunk_seq: Dict[int, int] = {}  # request_id -> next chunk seq
        self._killed = False
        self._health = None
        self._health_port = health_port
        self.param_loader = param_loader
        self.weights_version = 0

    # -- membership ------------------------------------------------------------
    def register(self) -> int:
        """Claim a fresh channel and announce this host's profile: ``add``
        on the members counter hands out the channel, the announce key
        written after it carries the profile. A recovered host rejoining
        is one more join: a new channel, clean cursors."""
        eng = self.scheduler.engine
        self.chan = self.store.add(self.keys.members(), 1) - 1
        self._in_cursor = 0
        self._out_seq = 0
        self.store.set(
            self.keys.member(self.chan),
            protocol.dumps(protocol.announce_msg(
                self.host_id, self.chan, n_slots=eng.n_slots,
                prefill_len=eng.prefill_len, max_len=eng.max_len,
                spec_k=eng.spec_k,
                page_size=eng.page_size if eng.cache_kind == "paged" else 0,
            )),
        )
        self._publish_load()
        if self._health_port is not None and self._health is None:
            from pytorch_distributed_tpu_torch.elastic.health import (
                HealthCheckServer,
            )

            self._health = HealthCheckServer(
                self._load_snapshot, port=self._health_port, host="127.0.0.1"
            ).start()
        if self.emit_events:
            record_event(
                "serving.host_join", source="multihost",
                host=self.host_id, chan=self.chan,
                n_slots=eng.n_slots, prefill_len=eng.prefill_len,
            )
        return self.chan

    def kill(self) -> None:
        """A crash: the loop exits as soon as it sees the flag, with no
        drain, no last flush and no more heartbeats."""
        self._killed = True

    # -- one loop ----------------------------------------------------------------
    def step(self) -> bool:
        """Drain the inbox, run one scheduler step, flush the tokens,
        publish the load and heartbeat. True if there was work."""
        self._check_weights()
        admitted = self._drain_inbox()
        did_decode = False
        if self.scheduler.has_work:
            finished = self.scheduler.step()
            did_decode = True
            for fin in finished:
                self._flush_tokens(fin.request_id, fin.tokens)
                self._emit_finished(fin)
        for st in self.scheduler.slots:     # requests still in flight
            if st is not None:
                self._flush_tokens(st.request.request_id, st.tokens)
        self._publish_load()
        return admitted > 0 or did_decode

    def serve_forever(self) -> None:
        """Register (if not yet) and loop until the stop key is set and the
        accepted work has drained, or :meth:`kill`."""
        if self.chan is None:
            self.register()
        while not self._killed:
            busy = self.step()
            if (not busy and self._stop_requested()
                    and not self.scheduler.has_work):
                self._publish_load(draining=True)
                break
            if not busy:
                time.sleep(self.idle_sleep_s)
        if self._health is not None:
            self._health.stop()
            self._health = None

    # -- internals -----------------------------------------------------------------
    def _check_weights(self) -> None:
        """Swap a pushed checkpoint in, between scheduler steps (the one
        place a swap is safe): the decodes in flight go on with the new
        weights at the next step, and with greedy sampling and equal values
        not one token of them changes."""
        if self.param_loader is None or self.chan is None:
            return
        raw = self.store.get_nowait(self.keys.weights(self.chan))
        if raw is None:
            return
        msg = protocol.loads(raw)
        version = int(msg["version"])
        if version <= self.weights_version:
            return
        state = self.param_loader(msg["ckpt_dir"], msg["step"])
        cost = self.scheduler.swap_params(state)
        self.weights_version = version
        if self.emit_events:
            record_event(
                "serving.weight_push", source="multihost",
                host=self.host_id, chan=self.chan, version=version,
                ckpt_dir=msg["ckpt_dir"], step=msg["step"],
                bytes_moved=cost.bytes_moved, peak_bytes=cost.peak_bytes,
                naive_gather_bytes=cost.naive_gather_bytes,
            )

    def _stop_requested(self) -> bool:
        return self.store.get_nowait(self.keys.stop(self.chan)) is not None

    def _drain_inbox(self) -> int:
        n = 0
        while True:
            key = self.keys.inbox(self.chan, self._in_cursor)
            raw = self.store.get_nowait(key)
            if raw is None:
                return n
            self.store.delete_key(key)
            self._in_cursor += 1
            msg = protocol.loads(raw)
            rid = int(msg["request_id"])
            self._routes[rid] = int(msg["route_id"])
            self._chunk_seq.setdefault(rid, 0)
            self._sent.setdefault(rid, 0)
            prompt = np.asarray(msg["prompt"], np.int64)
            eng = self.scheduler.engine
            if (prompt.shape[0] > eng.prefill_len
                    or prompt.shape[0] >= eng.max_len):
                # the router checks host profiles before routing: this is
                # the path of a misconfigured deployment
                self._post(protocol.finished_msg(
                    rid, self._routes[rid], self._chunk_seq[rid],
                    reason="rejected", n_tokens=0, ttft_s=0.0, total_s=0.0,
                ))
                self._forget(rid)
                n += 1
                continue
            self.scheduler.submit(Request(
                prompt=prompt,
                max_new_tokens=int(msg["max_new_tokens"]),
                eos_token=msg["eos_token"],
                request_id=rid,
            ))
            n += 1

    def _flush_tokens(self, rid: int, tokens) -> None:
        sent = self._sent.get(rid, 0)
        route = self._routes.get(rid)
        if route is None:
            return
        while sent < len(tokens):
            chunk = [int(t) for t in tokens[sent:sent + self.chunk_tokens]]
            self._post(protocol.tokens_chunk(
                rid, route, self._chunk_seq[rid], chunk
            ))
            self._chunk_seq[rid] += 1
            sent += len(chunk)
        self._sent[rid] = sent

    def _emit_finished(self, fin) -> None:
        route = self._routes.get(fin.request_id)
        if route is None:
            return
        self._post(protocol.finished_msg(
            fin.request_id, route, self._chunk_seq[fin.request_id],
            reason=fin.reason, n_tokens=len(fin.tokens),
            ttft_s=fin.ttft_s, total_s=fin.total_s,
        ))
        self._forget(fin.request_id)

    def _forget(self, rid: int) -> None:
        self._sent.pop(rid, None)
        self._routes.pop(rid, None)
        self._chunk_seq.pop(rid, None)

    def _post(self, msg) -> None:
        self.store.set(
            self.keys.outbox(self.chan, self._out_seq), protocol.dumps(msg)
        )
        self._out_seq += 1

    def _load_snapshot(self, draining: bool = False) -> dict:
        sched = self.scheduler
        return protocol.load_msg(
            hb=self._hb, active=sched.n_active, queued=len(sched.queue),
            n_slots=sched.engine.n_slots, draining=draining,
            accept_num=sched.accept_rate.num, accept_den=sched.accept_rate.den,
            weights_version=self.weights_version,
            free_pages=sched.free_pages,
        )

    def _publish_load(self, draining: bool = False) -> None:
        self._hb += 1
        self.store.set(
            self.keys.load(self.chan),
            protocol.dumps(self._load_snapshot(draining)),
        )
        if self._health is not None:
            self._health.heartbeat()
