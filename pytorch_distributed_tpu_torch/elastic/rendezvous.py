"""Dynamic rendezvous: store-backed elastic membership.

Port of ``pytorch_distributed_tpu/elastic/rendezvous.py`` (torch
``distributed/elastic/rendezvous/dynamic_rendezvous.py``) over the port's
stores (``distributed.store``): rounds with join/close phases, keep-alive heartbeats
(default 5s, matching ``dynamic_rendezvous.py:147``), dead-node eviction via
stale heartbeats, and ``num_nodes_waiting`` so agents detect scale-up and
re-rendezvous.

Protocol per round r (keys under ``rdzv/{run_id}/{r}/``):
  join:   node_rank = add("joined", 1) - 1; node posts heartbeat
  close:  when joined >= min_nodes, the round closes after ``last_call``
          grace (or immediately at max_nodes); closer writes "closed" = n
  barrier: every participant waits for "closed"
Late joiners (round already closed) bump ``waiting`` — existing agents poll
:meth:`num_nodes_waiting` and restart into round r+1.
"""

from __future__ import annotations

import threading
import time
from datetime import timedelta
from typing import Optional, Tuple

from pytorch_distributed_tpu_torch.distributed.store import (
    Store,
    StoreTimeoutError,
)

__all__ = ["DynamicRendezvous", "RendezvousClosedError"]


class RendezvousClosedError(RuntimeError):
    """The run was permanently closed (``shutdown()``): no further rounds
    will form, so joiners and waiters fail instead of blocking (torch
    ``RendezvousClosedError`` semantics)."""


class DynamicRendezvous:
    def __init__(
        self,
        store: Store,
        run_id: str,
        min_nodes: int,
        max_nodes: int,
        *,
        last_call_timeout: float = 2.0,
        join_timeout: float = 600.0,
        keep_alive_interval: float = 5.0,
        keep_alive_max_misses: int = 3,
    ):
        self.store = store
        self.run_id = run_id
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.last_call_timeout = last_call_timeout
        self.join_timeout = join_timeout
        self.keep_alive_interval = keep_alive_interval
        self.keep_alive_max_misses = keep_alive_max_misses
        self.round: Optional[int] = None
        self.node_rank: Optional[int] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self._dead_cache: Optional[tuple] = None  # ((round, n), [dead])
        self._dead_cache_ts = 0.0

    def _k(self, r: int, suffix: str) -> str:
        return f"rdzv/{self.run_id}/{r}/{suffix}"

    def _current_round(self) -> int:
        return self.store.add(f"rdzv/{self.run_id}/round", 0)

    def _closed_key(self) -> str:
        return f"rdzv/{self.run_id}/closed_permanently"

    def _raise_if_closed(self) -> None:
        if self.store.check([self._closed_key()]):
            raise RendezvousClosedError(
                f"rendezvous {self.run_id!r} was shut down"
            )

    # -- join --------------------------------------------------------------
    def next_rendezvous(self) -> Tuple[int, int, int]:
        """Join the next round; returns (round, node_rank, num_nodes).

        Blocks until the round closes with >= min_nodes members. A node
        whose join lands after the round closed (or that got a rank beyond
        the closing size) re-enters the following round instead of failing
        (torch retries the handler too).
        """
        self.stop_heartbeat()
        deadline = time.monotonic() + self.join_timeout
        while True:
            if time.monotonic() > deadline:
                raise StoreTimeoutError("rendezvous join timed out")
            self._raise_if_closed()
            r = self._current_round()
            if self.store.check([self._k(r, "closed")]):
                # round already closed: signal we're waiting, nudge agents
                self._wait_next_round(r, deadline)
                continue
            node_rank = self.store.add(self._k(r, "joined"), 1) - 1
            if node_rank >= self.max_nodes:
                # overflow: wait for the next round
                self._wait_next_round(r, deadline)
                continue

            self.round, self.node_rank = r, node_rank
            self._dead_cache = None  # heartbeat keys are per-round
            self._start_heartbeat()

            # close phase: node 0 coordinates
            if node_rank == 0:
                joined = self.store.add(self._k(r, "joined"), 0)
                grace_deadline: Optional[float] = None
                while True:
                    if joined >= self.max_nodes:
                        break
                    if joined >= self.min_nodes:
                        if grace_deadline is None:
                            grace_deadline = (
                                time.monotonic() + self.last_call_timeout
                            )
                        elif time.monotonic() >= grace_deadline:
                            break
                    elif grace_deadline is not None:
                        grace_deadline = None  # membership shrank below min
                    if time.monotonic() > deadline:
                        raise StoreTimeoutError(
                            f"rendezvous: only {joined}/{self.min_nodes} nodes"
                        )
                    time.sleep(0.05)
                    joined = self.store.add(self._k(r, "joined"), 0)
                num_nodes = min(joined, self.max_nodes)
                self.store.set(self._k(r, "closed"), str(num_nodes))
            remaining = max(0.0, deadline - time.monotonic())
            payload = self.store.get(
                self._k(r, "closed"), timeout=timedelta(seconds=remaining)
            )
            num_nodes = int(payload)
            if node_rank >= num_nodes:
                # joined between node-0's final joined read and its close:
                # fall into the next round rather than failing the agent
                self.stop_heartbeat()
                self._wait_next_round(r, deadline)
                continue
            return r, node_rank, num_nodes

    def _wait_next_round(self, r: int, deadline: float) -> None:
        """Signal we're waiting (agents restart on seeing waiters) and block
        until some agent advances membership past round ``r``, honoring the
        caller's overall deadline and a permanent shutdown."""
        self.store.add(self._k(r, "waiting"), 1)
        adv_key = f"rdzv/{self.run_id}/round_advanced/{r}"
        # park in blocking store.wait in ~1s chunks (not a tight poll — the
        # store server would take ~40 RPCs/s per waiter), surfacing for a
        # closed-run check between chunks
        while True:
            self._raise_if_closed()
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise StoreTimeoutError(
                    f"rendezvous: round {r} never advanced within the join "
                    f"timeout"
                )
            try:
                self.store.wait(
                    [adv_key],
                    timeout=timedelta(seconds=min(1.0, remaining)),
                )
                return
            except StoreTimeoutError:
                continue

    def advance_round(self) -> None:
        """Move membership to the next round (called by an agent before
        re-rendezvous on restart/scale events)."""
        if self.round is None:
            return
        r = self.round
        cur = self._current_round()
        if cur == r:
            # first advancer wins; bump counter and release waiters
            self.store.add(f"rdzv/{self.run_id}/round", 1)
        self.store.set(f"rdzv/{self.run_id}/round_advanced/{r}", b"1")

    # -- scale detection ---------------------------------------------------
    def num_nodes_waiting(self) -> int:
        if self.round is None:
            return 0
        return self.store.add(self._k(self.round, "waiting"), 0)

    def round_changed(self) -> bool:
        """True when another agent already advanced past our round (its
        group restarted) — we must re-rendezvous too."""
        return self.round is not None and self._current_round() != self.round

    # -- heartbeats --------------------------------------------------------
    def _hb_key(self, node_rank: int) -> str:
        return self._k(self.round, f"hb/{node_rank}")

    def _start_heartbeat(self) -> None:
        self._hb_stop.clear()

        def beat():
            while not self._hb_stop.wait(self.keep_alive_interval):
                try:
                    self.store.set(self._hb_key(self.node_rank),
                                   str(time.time()))
                except Exception:
                    return
        self.store.set(self._hb_key(self.node_rank), str(time.time()))
        self._hb_thread = threading.Thread(target=beat, daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=1)
            self._hb_thread = None

    def dead_nodes(self, num_nodes: int) -> list:
        """Node ranks whose heartbeat is older than the miss budget.

        Results are cached for half a keep-alive interval: heartbeats only
        change every ``keep_alive_interval`` seconds, so re-reading N store
        keys on every 0.1 s agent monitor tick buys nothing. The cache is
        per round: a round change invalidates it.
        """
        now = time.time()
        cache_key = (self.round, num_nodes)
        if (
            self._dead_cache is not None
            and self._dead_cache[0] == cache_key
            and now - self._dead_cache_ts < self.keep_alive_interval / 2
        ):
            return list(self._dead_cache[1])
        horizon = self.keep_alive_interval * self.keep_alive_max_misses
        dead = []
        for nr in range(num_nodes):
            try:
                ts = float(self.store.get(
                    self._hb_key(nr), timeout=timedelta(milliseconds=50)))
            except StoreTimeoutError:
                dead.append(nr)
                continue
            if now - ts > horizon:
                dead.append(nr)
        self._dead_cache = (cache_key, dead)
        self._dead_cache_ts = now
        return list(dead)

    def shutdown(self) -> None:
        """Permanently close the run: joiners and round-waiters raise
        RendezvousClosedError instead of blocking on rounds that will
        never form (torch: a closed rendezvous terminates the job)."""
        self.stop_heartbeat()
        try:
            self.store.set(self._closed_key(), b"1")
        except Exception:
            pass  # store may already be gone at teardown
