"""Gradient communication hooks (torch DDP comm-hook parity,
``ddp_comm_hooks/default_hooks.py``).

Port of ``pytorch_distributed_tpu/parallel/comm_hooks.py``. A hook is
``hook(grads, group) -> synced``: the list of this rank's gradients (after
accumulation) and the data-parallel process group in, the list of their
means over the group out, in the same order, shapes and dtypes.
``Trainer(comm_hook=...)`` under ``DataParallel`` calls it in place of the
strategy's own reduction, once a step (no_sync semantics). Every
collective goes through ``parallel.comm``, so ``comm.counts`` and
``comm.wire_bytes`` show what a hook put on the wire.

* :func:`allreduce_hook`: the full-precision mean; the gradients of one
  dtype flattened into one buffer, one all-reduce (sum) per dtype, then a
  division by the group size.
* :data:`bf16_compress`, :data:`fp16_compress`: the floating gradients cast
  to the 16-bit dtype into one buffer, summed on the wire in 16 bits,
  divided by the group size in 16 bits and cast back, the order of
  ``lax.pmean`` over the cast gradients; others take the plain mean.
* :func:`make_bucketed_rs_hook` (``"reduce_scatter"``): consecutive
  same-dtype floating gradients packed into buckets of at most
  ``bucket_cap_mb`` (25 MB, torch's ``bucket_cap_mb``), each padded to a
  multiple of the group size, reduce-scattered, divided, all-gathered.
* :func:`make_ring_allreduce_hook` (``"ring_allreduce"``): 4 MB buckets,
  each summed by a hand-written ring of 2(n - 1) neighbour hops
  (``batch_isend_irecv``: send right, receive left), the reference's
  chunk bookkeeping, so the sums come out in its order; a one-rank group
  returns the buckets as they are, before any hop.

The reference's torch parameter order differs from the flax tree's sorted
keys, so the bucket boundaries of a model differ between the two packages
(a hook given the same list of gradients makes the same buckets).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.parallel import comm

__all__ = [
    "allreduce_hook",
    "bf16_compress",
    "fp16_compress",
    "make_bucketed_rs_hook",
    "make_ring_allreduce_hook",
    "reduce_scatter_hook",
    "ring_allreduce_hook",
    "get_comm_hook",
    "plan_buckets",
]


def _size(group) -> int:
    return dist.get_world_size(group)


def _flat_mean(grads: Sequence[torch.Tensor], group,
               wire_dtype=None) -> List[torch.Tensor]:
    """The mean over ``group`` of ``grads`` (all of one dtype): one buffer
    (in ``wire_dtype`` where given), one all-reduce, divided in the wire
    dtype, cast back to each gradient's dtype."""
    flat = torch.cat([g.reshape(-1).to(wire_dtype or g.dtype)
                      for g in grads])
    comm.all_reduce(flat, group)
    if not flat.is_floating_point():    # lax.pmean of integers: fp32 means
        return [part.view_as(g).float() / _size(group) for g, part in
                zip(grads, flat.split([g.numel() for g in grads]))]
    flat /= _size(group)
    return [part.view_as(g).to(g.dtype)
            for g, part in zip(grads, flat.split([g.numel() for g in grads]))]


def _by_dtype(grads, fn) -> List[torch.Tensor]:
    """``fn`` over each dtype's gradients, the results put back in order."""
    out: List = [None] * len(grads)
    groups = {}
    for i, g in enumerate(grads):
        groups.setdefault(g.dtype, []).append(i)
    for idxs in groups.values():
        for i, new in zip(idxs, fn([grads[i] for i in idxs])):
            out[i] = new
    return out


@torch.no_grad()
def allreduce_hook(grads: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The full-precision mean (torch ``allreduce_hook``)."""
    return _by_dtype(grads, lambda gs: _flat_mean(gs, group))


def _compress_hook(dtype: torch.dtype) -> Callable:
    @torch.no_grad()
    def hook(grads, group):
        def one_dtype(gs):
            if not gs[0].is_floating_point():
                return _flat_mean(gs, group)
            return _flat_mean(gs, group, wire_dtype=dtype)

        return _by_dtype(grads, one_dtype)

    hook.__name__ = f"{str(dtype).removeprefix('torch.')}_compress"
    return hook


#: bf16-compressed mean (torch ``bf16_compress_hook``)
bf16_compress = _compress_hook(torch.bfloat16)
#: fp16-compressed mean (torch ``fp16_compress_hook``)
fp16_compress = _compress_hook(torch.float16)


def plan_buckets(grads: Sequence[torch.Tensor], cap_bytes: int):
    """The reference's bucketing: ``(buckets, plain)``, where ``buckets``
    lists the indices of consecutive floating gradients of one dtype up to
    ``cap_bytes`` each (a gradient larger than the cap is a bucket of its
    own), and ``plain`` the indices of non-floating ones (plain mean)."""
    buckets, plain = [], []
    dtype, size = None, 0
    for i, g in enumerate(grads):
        if not g.is_floating_point():
            plain.append(i)
            continue
        nbytes = g.numel() * g.element_size()
        if buckets and dtype == g.dtype and size + nbytes <= cap_bytes:
            buckets[-1].append(i)
            size += nbytes
        else:
            buckets.append([i])
            dtype, size = g.dtype, nbytes
    return buckets, plain


def _make_bucketed_hook(cap_bytes: int, reduce_flat: Callable) -> Callable:
    """Buckets of :func:`plan_buckets`, each packed into one flat vector
    padded to a multiple of the group size, handed to ``reduce_flat(flat,
    group, n) -> mean`` and unpacked into the gradients' shapes."""

    @torch.no_grad()
    def hook(grads, group):
        n = _size(group)
        out: List = [None] * len(grads)
        buckets, plain = plan_buckets(grads, cap_bytes)
        if plain:
            for i, new in zip(plain, allreduce_hook([grads[i] for i in plain],
                                                    group)):
                out[i] = new
        for idxs in buckets:
            flat = torch.cat([grads[i].reshape(-1) for i in idxs])
            pad = (-flat.numel()) % n
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            full = reduce_flat(flat, group, n)
            off = 0
            for i in idxs:
                g = grads[i]
                out[i] = full[off:off + g.numel()].view_as(g)
                off += g.numel()
        return out

    return hook


def make_bucketed_rs_hook(bucket_cap_mb: float = 25.0) -> Callable:
    """Bucketed reduce-scatter + all-gather gradient mean: the all-reduce
    as its two halves, a bucket at a time (the op class the TPU scheduler
    overlaps with the backward, ``comm_hooks.py:136`` of the reference).
    Each rank divides its reduced block by the group size before the
    gather."""

    def rs_ag(flat, group, n):
        block = flat.new_empty(flat.numel() // n)
        comm.reduce_scatter(block, flat, group)
        block /= n
        full = torch.empty_like(flat)
        comm.all_gather(full, block, group)
        return full

    return _make_bucketed_hook(int(bucket_cap_mb * 1024 * 1024), rs_ag)


#: default-capacity bucketed rs+ag sync (``comm_hook="reduce_scatter"``)
reduce_scatter_hook = make_bucketed_rs_hook()


def _ring_sum(flat: torch.Tensor, group, n: int) -> torch.Tensor:
    """``flat`` ([n * chunk]) summed over the group by 2(n - 1) hops of a
    ring (rank ``i`` sends to ``i + 1`` and receives from ``i - 1``), with
    the reference's chunk bookkeeping: after the n - 1 reduce-scatter hops
    rank ``i`` holds the whole sum of chunk ``(i + 1) % n``, which the
    n - 1 all-gather hops pass round."""
    idx = dist.get_rank(group)
    right, left = (idx + 1) % n, (idx - 1) % n
    chunks = flat.view(n, -1)
    buf = chunks[idx].clone()
    recv = torch.empty_like(buf)
    for s in range(n - 1):
        comm.p2p(group, sends=[(buf, right)], recvs=[(recv, left)])
        buf = recv + chunks[(idx - s - 1) % n]
    out = torch.empty_like(chunks)
    out[(idx + 1) % n] = buf
    for s in range(n - 1):
        comm.p2p(group, sends=[(buf.contiguous(), right)],
                 recvs=[(recv, left)])
        buf = recv.clone()
        out[(idx - s) % n] = buf
    return out.view(-1)


def make_ring_allreduce_hook(bucket_cap_mb: float = 4.0) -> Callable:
    """Bucketed gradient mean through a hand-written ring all-reduce of
    neighbour hops (the reference's ``ppermute`` ring). Buckets are smaller
    than torch's 25 MB: each bucket's ring is a serial chain of 2(n - 1)
    hops, and more buckets give more chains to interleave."""

    def ring_mean(flat, group, n):
        if n == 1:
            return flat
        return _ring_sum(flat, group, n) / n

    return _make_bucketed_hook(int(bucket_cap_mb * 1024 * 1024), ring_mean)


#: default ring all-reduce sync (``comm_hook="ring_allreduce"``)
ring_allreduce_hook = make_ring_allreduce_hook()

_REGISTRY = {
    "allreduce": allreduce_hook,
    "bf16_compress": bf16_compress,
    "fp16_compress": fp16_compress,
    "reduce_scatter": reduce_scatter_hook,
    "ring_allreduce": ring_allreduce_hook,
}


def get_comm_hook(hook) -> Callable:
    """A hook name of the registry, or a callable, as ``hook(grads,
    group)``."""
    if callable(hook):
        return hook
    try:
        return _REGISTRY[hook]
    except KeyError:
        raise ValueError(
            f"unknown comm hook {hook!r} (have {sorted(_REGISTRY)})"
        ) from None
