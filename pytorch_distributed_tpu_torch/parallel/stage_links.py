"""Point-to-point links between the stages of a pipeline.

The reference's stages exchange numpy arrays over its own process group,
whose receiver learns each array's shape and dtype from the payload and
matches messages by tag. c10d receives into a buffer of a known shape, and
its backends differ in what they match on, so this layer adds what the
pipeline needs over the port's ``distributed.process_group``:

* **Two kinds of message.** ``send``/``recv`` carry a tensor whose shape
  and dtype both sides know (GPipe's activations: every stage's input and
  output have the microbatch's shape). ``isend_msg``/``irecv_msg`` carry a
  typed message: a header (the message's tag, its dtype, ndim and shape;
  ``HEADER`` int64 numbers) ahead of the payload, so a stage may send any
  shape (the eager executor's heterogeneous stages).
* **Tags and order.** On gloo, a message's header goes under tag ``2 tag``
  and its payload under ``2 tag + 1``, and c10d matches them by tag. NCCL
  has no tags: a pair's messages match in the order they were issued. So
  on an NCCL group a receiver takes the pair's messages in the order the
  sender sent them, reading each header's tag, and keeps a message that
  came before the one it waits for until it is asked for (``_early``).
  Each pair's receives are then issued in the order of its sends, on both
  sides, whatever order the schedule needs them in.
* **Card tensors on gloo.** gloo will not send a card tensor point to
  point, so on a gloo group of card ranks each payload goes through a
  pinned host buffer: copied there before the send, and to the card after
  the receive. ``counts["host_staged_bytes"]`` adds both copies' bytes.

``counts`` holds the messages and bytes since :func:`reset_counts`
(payloads only: a header is ``HEADER * 8`` bytes more a message).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.distributed.batch_ops import (
    as_process_group,
)

__all__ = ["HEADER", "StageLinks", "counts", "reset_counts"]

_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64,
           torch.int32, torch.int64, torch.int16, torch.int8, torch.uint8,
           torch.bool)
_MAX_DIM = 8
#: int64 numbers of a typed message's header: tag, dtype, ndim, the dims
HEADER = 3 + _MAX_DIM

#: since the last ``reset_counts``: payload messages sent and received,
#: their bytes, and the bytes copied through pinned host memory
counts: Dict[str, int] = {}


def reset_counts() -> None:
    counts.clear()
    counts.update(sends=0, recvs=0, sent_bytes=0, recv_bytes=0,
                  host_staged_bytes=0)


reset_counts()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def backend_name(pg) -> str:
    """``"nccl"``, ``"gloo"``, ... of a port ``ProcessGroup`` (or ``""``
    for a group that is not a c10d one)."""
    group = getattr(pg.backend, "group", None)
    try:
        return str(dist.get_backend(group))
    except (ValueError, RuntimeError, TypeError, AttributeError):
        name = getattr(group, "name", None)
        return str(name()) if callable(name) else ""


class _Sent:
    """The works of one message; keeps its buffers alive until they
    complete."""

    def __init__(self, works: Sequence, keep: Tuple):
        self._works, self._keep = list(works), keep

    def is_completed(self) -> bool:
        return all(w.is_completed() for w in self._works)

    def wait(self) -> None:
        for w in self._works:
            w.wait()
        self._keep = ()


class _Pending:
    """A typed message being received: ``wait()`` returns its tensor."""

    def __init__(self, take):
        self._take = take

    def wait(self) -> torch.Tensor:
        return self._take()


class StageLinks:
    """The links of one rank to the other stages of ``pg`` (a port
    ``ProcessGroup`` or a c10d group; ranks are the group's), landing
    tensors on ``device``."""

    def __init__(self, pg, device):
        self.pg = as_process_group(pg)
        self.device = torch.device(device)
        self.backend = backend_name(self.pg)
        #: NCCL: a pair's messages match in issue order, not by tag
        self.ordered = self.backend == "nccl"
        #: card tensors over gloo go through pinned host memory
        self.host = self.device.type != "cpu" and not self.ordered
        self._early: Dict[int, Dict[int, torch.Tensor]] = {}

    # -- staging -----------------------------------------------------------
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if not self.host:
            return t.contiguous()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        counts["host_staged_bytes"] += _nbytes(t)
        return buf

    def _buffer(self, shape, dtype) -> torch.Tensor:
        if self.host:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _land(self, buf: torch.Tensor) -> torch.Tensor:
        counts["recvs"] += 1
        counts["recv_bytes"] += _nbytes(buf)
        if not self.host:
            return buf
        counts["host_staged_bytes"] += _nbytes(buf)
        return buf.to(self.device)

    def _count_send(self, t: torch.Tensor) -> None:
        counts["sends"] += 1
        counts["sent_bytes"] += _nbytes(t)

    # -- known shapes ------------------------------------------------------
    def send(self, t: torch.Tensor, dst: int, tag: int) -> None:
        """Send ``t`` to ``dst``, whose receiver knows its shape and dtype
        (blocking)."""
        self._count_send(t)
        self.pg.send(self._wire(t), dst, tag)

    def recv(self, shape, dtype, src: int, tag: int) -> torch.Tensor:
        """Receive a tensor of ``shape`` and ``dtype`` from ``src``."""
        buf = self._buffer(shape, dtype)
        self.pg.recv(buf, src, tag)
        return self._land(buf)

    # -- typed messages ----------------------------------------------------
    def _header(self, t: torch.Tensor, tag: int) -> torch.Tensor:
        if t.dim() > _MAX_DIM:
            raise ValueError(f"a stage link carries up to {_MAX_DIM} dims, "
                             f"got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"a stage link does not carry {t.dtype}")
        words = [tag, _DTYPES.index(t.dtype), t.dim(), *t.shape]
        words += [0] * (HEADER - len(words))
        header = torch.tensor(words, dtype=torch.int64)
        return header.to(self.device) if self.ordered else header

    @staticmethod
    def _parse(header: torch.Tensor):
        words = header.cpu().tolist()
        tag, code, ndim = words[:3]
        return tag, _DTYPES[code], tuple(words[3:3 + ndim])

    def isend_msg(self, t: torch.Tensor, dst: int, tag: int) -> _Sent:
        """Post the typed message ``t`` to ``dst`` under ``tag``; returns
        its works (``wait``, ``is_completed``)."""
        header, wire = self._header(t, tag), self._wire(t)
        self._count_send(t)
        h_tag, p_tag = (0, 0) if self.ordered else (2 * tag, 2 * tag + 1)
        works = [self.pg.isend(header, dst, h_tag),
                 self.pg.isend(wire, dst, p_tag)]
        return _Sent(works, (header, wire))

    def send_msg(self, t: torch.Tensor, dst: int, tag: int) -> None:
        self.isend_msg(t, dst, tag).wait()

    def irecv_msg(self, src: int, tag: int) -> _Pending:
        """Start receiving the typed message ``tag`` from ``src``: on gloo
        its header's receive is posted now; on NCCL the pair's messages
        are received in their order when ``wait()`` is called."""
        if self.ordered:
            return _Pending(lambda: self._take(src, tag))
        header = torch.empty(HEADER, dtype=torch.int64)
        work = self.pg.irecv(header, src, 2 * tag)

        def take():
            work.wait()
            got, dtype, shape = self._parse(header)
            if got != tag:
                raise RuntimeError(f"stage link from {src}: message {got} "
                                   f"under tag {tag}")
            buf = self._buffer(shape, dtype)
            self.pg.recv(buf, src, 2 * tag + 1)
            return self._land(buf)

        return _Pending(take)

    def recv_msg(self, src: int, tag: int) -> torch.Tensor:
        return self.irecv_msg(src, tag).wait()

    def _take(self, src: int, tag: int) -> torch.Tensor:
        """NCCL: the pair's next messages, in the sender's order, until
        ``tag`` arrives; the ones before it wait in ``_early``."""
        early = self._early.setdefault(src, {})
        while tag not in early:
            header = torch.empty(HEADER, dtype=torch.int64,
                                 device=self.device)
            self.pg.recv(header, src, 0)
            got, dtype, shape = self._parse(header)
            buf = self._buffer(shape, dtype)
            self.pg.recv(buf, src, 0)
            early[got] = self._land(buf)
        return early.pop(tag)

    def pending(self) -> int:
        """Messages received ahead of their turn and not yet taken."""
        return sum(len(v) for v in self._early.values())
