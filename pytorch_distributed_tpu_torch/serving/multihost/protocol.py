"""Wire protocol of multihost serving: the key schema and the message codecs.

Port of ``pytorch_distributed_tpu/serving/multihost/protocol.py``, key for
key and byte for byte: a router and workers of either package speak one
wire format. Everything the router and the host workers exchange goes
through a :class:`~pytorch_distributed_tpu_torch.distributed.store.Store`
(``TCPStore`` between hosts, ``HashStore`` in one process, ``FileStore``
over a shared directory). The store orders nothing for us (``set``,
``get_nowait``, ``add``), so ordering and exactly-once are built here:

* **Channels, not host names.** Every worker registration claims a fresh
  channel from the ``members`` counter, and all its keys live under
  ``{ns}/chan/{i}/``. A host that dies and rejoins registers again and
  gets a new channel, so it never replays the old channel's inbox or
  meets its own stale outbox (the join counter of the elastic
  rendezvous).
* **Single-writer logs.** The router appends to a channel's inbox
  (``in/{n}``, ``n`` from the ``in_seq`` counter, the value written after
  the bump so the reader never sees a gap); the worker appends to its
  outbox (``out/{n}``, ``n`` its own count: one writer needs no counter).
  Each side reads its peer's log with a cursor and ``get_nowait`` and
  deletes what it has read.
* **Sequence numbers twice.** The outbox index orders the stream, and
  each request's token chunks also carry a per-request ``seq`` that the
  router asserts on, so a reassembly fault fails loudly.
* **Route incarnations.** Every routing of a request gets a fresh
  ``route_id``, which the worker echoes on every chunk; the router drops
  chunks of any other route. A host declared dead that is merely slow can
  go on publishing: its stream is ignored once the request is routed
  elsewhere.

Values are JSON: prompts and chunks are short int lists, and JSON keeps
the protocol readable with nothing but ``store.get``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

__all__ = ["Keys", "dumps", "loads", "DEFAULT_NAMESPACE"]

DEFAULT_NAMESPACE = "mhserve"


def dumps(obj: Dict[str, Any]) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


def loads(raw: bytes) -> Dict[str, Any]:
    return json.loads(raw.decode())


class Keys:
    """Key names of one serving deployment (one namespace)."""

    def __init__(self, namespace: str = DEFAULT_NAMESPACE):
        self.ns = namespace

    # -- membership (join counter) -------------------------------------------
    def members(self) -> str:
        return f"{self.ns}/members"

    def member(self, i: int) -> str:
        return f"{self.ns}/member/{i}"

    # -- a channel's request inbox (router -> worker) ------------------------
    def in_seq(self, chan: int) -> str:
        return f"{self.ns}/chan/{chan}/in_seq"

    def inbox(self, chan: int, n: int) -> str:
        return f"{self.ns}/chan/{chan}/in/{n}"

    # -- a channel's result outbox (worker -> router) ------------------------
    def outbox(self, chan: int, n: int) -> str:
        return f"{self.ns}/chan/{chan}/out/{n}"

    # -- load and heartbeat (one key, published every worker loop) -----------
    def load(self, chan: int) -> str:
        return f"{self.ns}/chan/{chan}/load"

    # -- the drain signal -----------------------------------------------------
    def stop(self, chan: int) -> str:
        return f"{self.ns}/chan/{chan}/stop"

    # -- live weight pushes ---------------------------------------------------
    def weights(self, chan: int) -> str:
        return f"{self.ns}/chan/{chan}/weights"


# -- message constructors (the shapes are documented here only) --------------

def announce_msg(host: str, chan: int, *, n_slots: int, prefill_len: int,
                 max_len: int, spec_k: int,
                 page_size: int = 0) -> Dict[str, Any]:
    """``page_size > 0`` marks a paged-cache host: its load snapshots carry
    a meaningful ``free_pages`` and the router sizes admissions in pages."""
    return {"host": host, "chan": chan, "n_slots": n_slots,
            "prefill_len": prefill_len, "max_len": max_len,
            "spec_k": spec_k, "page_size": page_size}


def wire_request(request_id: int, route_id: int, prompt: List[int],
                 max_new_tokens: int, eos_token: Optional[int]
                 ) -> Dict[str, Any]:
    return {"request_id": request_id, "route_id": route_id,
            "prompt": prompt, "max_new_tokens": max_new_tokens,
            "eos_token": eos_token}


def tokens_chunk(request_id: int, route_id: int, seq: int,
                 tokens: List[int]) -> Dict[str, Any]:
    return {"type": "tokens", "request_id": request_id,
            "route_id": route_id, "seq": seq, "tokens": tokens}


def finished_msg(request_id: int, route_id: int, seq: int, *, reason: str,
                 n_tokens: int, ttft_s: float, total_s: float
                 ) -> Dict[str, Any]:
    return {"type": "finished", "request_id": request_id,
            "route_id": route_id, "seq": seq, "reason": reason,
            "n_tokens": n_tokens, "ttft_s": ttft_s, "total_s": total_s}


def load_msg(*, hb: int, active: int, queued: int, n_slots: int,
             draining: bool, accept_num: int = 0,
             accept_den: int = 0, weights_version: int = 0,
             free_pages: int = -1) -> Dict[str, Any]:
    """``free_pages`` is the scheduler's admission capacity in KV pages
    (``Scheduler.free_pages``); -1 means a worker without the field."""
    return {"hb": hb, "active": active, "queued": queued,
            "n_slots": n_slots, "draining": draining,
            "accept_num": accept_num, "accept_den": accept_den,
            "weights_version": weights_version, "free_pages": free_pages}


def weights_msg(version: int, ckpt_dir: str,
                step: Optional[int]) -> Dict[str, Any]:
    """A live weight push: a worker that sees a version newer than the one
    it serves loads ``ckpt_dir`` (at ``step``; None is the newest) through
    its ``param_loader`` and swaps it in between decode steps."""
    return {"version": version, "ckpt_dir": ckpt_dir, "step": step}
