"""Executor for redistribution plans, between steps.

Port of ``pytorch_distributed_tpu/redistribute/executor.py``. The model is
SPMD over ``torch.distributed``: every rank of the union of a plan's
source and destination rank sets calls :func:`execute_plan` with its own
block of the source (the whole tensor for a host-resident source, None
where it holds nothing) and gets its block of the destination back (None
outside the destination's ranks). Each rank derives the same exchange from
the plan: the index box every rank holds before and after, and, for each
destination box, the pieces of the source boxes it overlaps, each taken
from the nearest rank that holds it (the receiver itself where it can).
Every path moves data only, so every result is bit-exact:

* a rank that holds all it needs (``noop``, ``dynamic_slice``, a relabel,
  a host source) narrows and copies, with no collective, and a rank whose
  block is already its destination block returns it as it is (the
  reference's noop and relabel alias their buffers);
* ``all_gather``: ``all_gather_into_tensor`` over the group of the axis
  the placement loses, each block then put at its place along the dim;
* ``all_to_all``: ``all_to_all_single`` over the group of the axis that
  moves between dims;
* anything else (a transition mixing axes, a copy across rank sets, a
  shrink of the world): point-to-point sends of the overlapping pieces
  over the default group. No rank builds a whole replica of a leaf whose
  destination is sharded.

A chunked step (``max_staging_bytes``) streams along ``chunk_dim``: the
destination block is allocated once (or is the caller's ``out``), and each
chunk's pieces pass through one staging buffer of at most
``max_staging_bytes`` (more chunks than the plan's when a rank's sends and
receives of a chunk would not fit) and are copied in place. A host source
landing on the card goes through one pinned staging buffer the same way.
On a gloo group, whose sends read host memory only, a card tensor's pieces
are staged through the host; the choice is made from the group's backend
before anything is sent. A sharded dim that does not divide evenly is
refused with ``ValueError``.

:data:`counts` is what the ranks really did, beside the plan's model: the
bytes this rank delivered to other ranks (``sent_bytes``), the bytes that
went through host staging (``host_staged_bytes``), the largest staging
buffer of a chunked step (``staging_bytes_max``) and the largest temporary
buffer of any step (``buffer_bytes_max``). With :data:`measure_peaks` set,
each leaf moved on the card also records the resident source and
destination blocks plus the most the allocator held above them during the
move (``measured_peak_bytes``, the largest over the leaves).

The reference's ``apply_in_jit`` and ``donated_update_jit`` have no
counterpart: torch has no traced value to carry a sharding constraint and
no donation; the chunked write is an in-place ``copy_``, and a same-mesh
step's collectives are ordinary calls a CUDA graph capture may record.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.parallel import comm
from pytorch_distributed_tpu_torch.redistribute.plan import (
    LeafPlan,
    Sharding,
    TreePlan,
    boxes,
    extent as _extent,
    flatten,
    intersect as _intersect,
    leaf_meta,
    mesh_ranks,
    plan_transfer,
    plan_tree,
    shift as _shift,
    unflatten,
)

__all__ = [
    "Placed",
    "counts",
    "reset_counts",
    "dtensor_sharding",
    "to_dtensor",
    "execute_plan",
    "redistribute",
    "redistribute_tree",
]

_KEYS = ("sent_bytes", "host_staged_bytes", "staging_bytes_max",
         "buffer_bytes_max", "measured_peak_bytes", "leaves")
#: what the executor did since the last :func:`reset_counts`
counts: Dict[str, int] = dict.fromkeys(_KEYS, 0)
#: record each card leaf's measured peak (resets the allocator's peak)
measure_peaks = False
#: with :data:`measure_peaks`, one entry a card leaf: ``name``, ``op``,
#: ``dst_sharded``, the plan's ``bytes_moved``/``peak_bytes``/
#: ``naive_gather_bytes`` and ``measured_peak_bytes``
leaf_peaks: List[Dict[str, Any]] = []


def reset_counts() -> None:
    counts.clear()
    counts.update(dict.fromkeys(_KEYS, 0))
    leaf_peaks.clear()


def _note_buffer(n: int, staging: bool = False) -> None:
    counts["buffer_bytes_max"] = max(counts["buffer_bytes_max"], n)
    if staging:
        counts["staging_bytes_max"] = max(counts["staging_bytes_max"], n)


class Placed(NamedTuple):
    """A rank's ``block`` of a tensor of global ``shape`` and ``dtype``
    held under ``sharding``; ``block`` is None on a rank that holds none
    (it still takes part in a move out of it)."""
    block: Optional[torch.Tensor]
    sharding: Sharding
    shape: Tuple[int, ...]
    dtype: torch.dtype


# -- placements of DTensors -------------------------------------------------
def to_dtensor(block: torch.Tensor, sharding: Sharding, shape):
    """A DTensor view of ``block`` on a ``DeviceMesh`` sharding (each
    dim's axes in mesh order): what a checkpoint saves and what
    :func:`dtensor_sharding` reads back."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    names = tuple(sharding.mesh.axis_names)
    placements = [Replicate()] * len(names)
    for d, axes in enumerate(sharding.spec):
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"{sharding}: a DTensor shards one dim over its "
                             "axes in mesh order")
        for a in axes:
            placements[names.index(a)] = Shard(d)
    shape = torch.Size(shape)
    return DTensor.from_local(
        block, sharding.mesh._mesh, placements, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def dtensor_sharding(x) -> Optional[Sharding]:
    """The :class:`Sharding` of a DTensor (its mesh, ``Shard(d)`` putting
    the mesh dim's axis on tensor dim ``d`` in mesh order); None for
    anything else."""
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # pragma: no cover
        return None
    if not isinstance(x, DTensor):
        return None
    from torch.distributed.tensor import Replicate, Shard

    from pytorch_distributed_tpu_torch.mesh import DeviceMesh

    tmesh = x.device_mesh
    mesh = DeviceMesh(tmesh, x.to_local().device)
    spec = [[] for _ in range(x.dim())]
    for axis, pl in zip(mesh.axis_names, x.placements):
        if type(pl) is Shard:
            spec[pl.dim].append(axis)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} of a DTensor cannot be "
                             "redistributed: Shard or Replicate only")
    return Sharding(mesh, [tuple(s) for s in spec])


def _local(x):
    if isinstance(x, Placed):
        return x.block
    to_local = getattr(x, "to_local", None)
    return to_local() if to_local is not None else x


# -- boxes --------------------------------------------------------------------
def _even_boxes(shape, sharding, name) -> Dict[int, Tuple]:
    """:func:`plan.boxes`, refusing a sharded dim that does not divide."""
    for d, axes in enumerate(sharding.spec):
        factor = math.prod(dict(sharding.mesh.shape)[a] for a in axes)
        if factor > 1 and shape[d] % factor:
            raise ValueError(
                f"{name or 'leaf'}: dim {d} of {tuple(shape)} does not split "
                f"evenly into {factor} over {axes}")
    return boxes(shape, sharding)


def _take(t: torch.Tensor, box) -> torch.Tensor:
    for d, (lo, hi) in enumerate(box):
        if lo != 0 or hi != t.shape[d]:
            t = t.narrow(d, lo, hi - lo)
    return t


def _coords(mesh, rank) -> Tuple[int, ...]:
    sizes = dict(mesh.shape)
    flat = mesh_ranks(mesh).index(rank)
    out = []
    for a in reversed(tuple(mesh.axis_names)):
        out.append(flat % sizes[a])
        flat //= sizes[a]
    return tuple(reversed(out))


def _me(*meshes) -> int:
    """This process's global rank; without a process group, the rank of
    its coordinates on the first mesh that knows them (a stand-in mesh)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    for mesh in meshes:
        if mesh is None or not hasattr(mesh, "get_local_rank"):
            continue
        sizes = dict(mesh.shape)
        flat = 0
        for a in mesh.axis_names:
            flat = flat * sizes[a] + mesh.get_local_rank(a)
        return mesh_ranks(mesh)[flat]
    return 0


class _Leaf:
    """One leaf's exchange: the boxes (leaf coordinates) each rank holds
    before (``src``; every destination rank for a host source) and after
    (``dst``), and ``moves``, ``(from, to, box)`` for every piece."""

    def __init__(self, plan: LeafPlan, name):
        shape, region = plan.shape, plan.region
        self.dst = _even_boxes(shape, plan.dst, name)
        self.host = plan.src is None
        if self.host:
            whole = tuple((0, n) for n in shape)
            self.src = dict.fromkeys(self.dst, whole)
            self.origin = {r: (0,) * len(shape) for r in self.dst}
        else:
            full_shape, offset = region or (shape, (0,) * len(shape))
            window = tuple((o, o + n) for o, n in zip(offset, shape))
            self.src, self.origin = {}, {}
            for r, box in _even_boxes(full_shape, plan.src, name).items():
                # origin: where the rank's block starts, in leaf coordinates
                self.origin[r] = tuple(lo - o for (lo, _), o in zip(box, offset))
                cut = _intersect(box, window)
                if cut is not None:
                    self.src[r] = _shift(cut, offset)
        self.moves = self._moves(plan)

    def _moves(self, plan):
        holders: Dict[Tuple, List[int]] = {}
        for r, box in self.src.items():
            holders.setdefault(box, []).append(r)
        same_mesh = (plan.src is not None and plan.src.ranks == plan.dst.ranks
                     and dict(plan.src.mesh.shape) == dict(plan.dst.mesh.shape))
        moves = []
        for i, q in enumerate(self.dst):
            for box in sorted(holders):
                piece = _intersect(box, self.dst[q])
                if piece is None:
                    continue
                have = holders[box]
                if q in have:
                    p = q
                elif same_mesh:
                    # the holder nearest on the mesh (one axis away for a
                    # collective over that axis), ties spread by receiver
                    cq = _coords(plan.dst.mesh, q)
                    dist_of = [sum(a != b for a, b in zip(
                        _coords(plan.src.mesh, h), cq)) for h in have]
                    best = min(dist_of)
                    near = [h for h, d in zip(have, dist_of) if d == best]
                    p = near[i % len(near)]
                else:
                    p = have[i % len(have)]
                moves.append((p, q, piece))
        return moves


def _backend(group=None) -> Optional[str]:
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.get_backend(group)


def _stage_through_host(t: torch.Tensor, group=None) -> bool:
    """A card tensor on a gloo group goes through host memory."""
    return t.device.type != "cpu" and _backend(group) == "gloo"


def _nbytes(box, itemsize) -> int:
    return math.prod(_extent(box)) * itemsize


def _record_sent(n: int) -> None:
    counts["sent_bytes"] += n


# -- transports ---------------------------------------------------------------
def _dst_origin(leaf: _Leaf, me) -> Tuple[int, ...]:
    return tuple(lo for lo, _ in leaf.dst[me]) if me in leaf.dst else ()


def _copy_local(leaf: _Leaf, x, out, me, moves) -> None:
    if out is x:    # aliased: the block is in place already
        return
    for p, q, box in moves:
        if p == me and q == me:
            _take(out, _shift(box, _dst_origin(leaf, me))).copy_(
                _take(x, _shift(box, leaf.origin[me])))


def _p2p(leaf: _Leaf, x, out, me, moves, staging=None) -> None:
    """Point-to-point pieces over the default group; ``staging`` is one
    flat buffer that holds this rank's sends and receives of ``moves``.
    Without a given buffer or host staging, a piece that is a contiguous
    view of the source block is sent from it, and one that is a
    contiguous view of the destination block is received into it (an
    expert stack's experts along dim 0): only the others are staged."""
    dst_origin = _dst_origin(leaf, me)
    card = out if out is not None else x
    dtype, itemsize = card.dtype, card.element_size()
    host = _stage_through_host(card)
    direct = staging is None and not host
    sends, recvs, n = [], [], 0
    for p, q, box in moves:
        if p == me and q != me:
            peer, view, pieces = q, _take(x, _shift(box, leaf.origin[me])), \
                sends
        elif q == me and p != me:
            peer, view, pieces = p, _take(out, _shift(box, dst_origin)), recvs
        else:
            continue
        if not (direct and view.is_contiguous()):
            view = None
            n += math.prod(_extent(box))
        pieces.append((peer, box, view))
    device = card.device
    if staging is None:
        staging = torch.empty(n, dtype=dtype,
                              device="cpu" if host else device,
                              pin_memory=host)
        _note_buffer(n * itemsize)
    at, send_ops, recv_ops = 0, [], []
    for q, box, view in sends:
        k = math.prod(_extent(box))
        if view is None:
            view = staging[at:at + k].view(_extent(box))
            view.copy_(_take(x, _shift(box, leaf.origin[me])))
            at += k
            if host:
                counts["host_staged_bytes"] += k * itemsize
        send_ops.append((view, q))
        _record_sent(k * itemsize)
    for p, box, view in recvs:
        k = math.prod(_extent(box))
        if view is None:
            recv_ops.append((staging[at:at + k].view(_extent(box)), p, box))
            at += k
        else:
            recv_ops.append((view, p, None))
    if send_ops or recv_ops:
        comm.p2p(None, sends=send_ops,
                 recvs=[(buf, p) for buf, p, _ in recv_ops])
    for buf, _, box in recv_ops:
        if box is None:         # received in place
            continue
        _take(out, _shift(box, dst_origin)).copy_(buf, non_blocking=False)
        if host:
            counts["host_staged_bytes"] += buf.numel() * itemsize
    _copy_local(leaf, x, out, me, moves)


def _mesh_group(plan: LeafPlan, kind: str):
    """``(axis, group)`` of a one-axis collective that does the step, or
    None: ``all_gather`` when the placement loses exactly one axis,
    ``all_to_all`` when exactly one axis moves between dims, on one mesh,
    the other dims unchanged."""
    src, dst = plan.src, plan.dst
    if src is None or not hasattr(src.mesh, "get_group"):
        return None
    if src.mesh is not dst.mesh and (
            src.ranks != dst.ranks
            or tuple(src.mesh.axis_names) != tuple(dst.mesh.axis_names)
            or dict(src.mesh.shape) != dict(dst.mesh.shape)):
        return None
    ndim = len(plan.shape)
    sa = src.spec + ((),) * (ndim - len(src.spec))
    da = dst.spec + ((),) * (ndim - len(dst.spec))
    diff = [d for d in range(ndim) if sa[d] != da[d]]
    if kind == "all_gather":
        if len(diff) != 1:
            return None
        d = diff[0]
        if len(sa[d]) != len(da[d]) + 1 or sa[d][:len(da[d])] != da[d]:
            return None
        axis = sa[d][-1]
    else:
        if len(diff) != 2:
            return None
        i, j = diff
        moved = set(sa[i]) - set(da[i])
        if len(moved) != 1:
            return None
        (axis,) = moved
        if not (sa[i] == da[i] + (axis,) and da[j] == sa[j] + (axis,)) and \
                not (sa[j] == da[j] + (axis,) and da[i] == sa[i] + (axis,)):
            return None
    return axis, src.mesh.get_group(axis)


def _members(mesh, axis, me) -> List[int]:
    """Global ranks of ``me``'s line along ``axis``, by coordinate."""
    names = tuple(mesh.axis_names)
    sizes = dict(mesh.shape)
    ranks = mesh_ranks(mesh)
    c = list(_coords(mesh, me))
    k = names.index(axis)
    out = []
    for v in range(sizes[axis]):
        c[k] = v
        flat = 0
        for a, cv in zip(names, c):
            flat = flat * sizes[a] + cv
        out.append(ranks[flat])
    return out


def _all_gather(leaf, plan, x, out, me, axis, group) -> None:
    members = _members(plan.src.mesh, axis, me)
    n = len(members)
    block = x.contiguous()
    host = _stage_through_host(block, group)
    inp = block.cpu() if host else block
    buf = torch.empty((n * block.shape[0], *block.shape[1:]),
                      dtype=block.dtype, device=inp.device)
    _note_buffer(buf.numel() * buf.element_size())
    comm.all_gather(buf, inp, group)
    nb = block.numel() * block.element_size()
    _record_sent((n - 1) * nb)
    if host:
        counts["host_staged_bytes"] += n * nb
    dst_origin = _dst_origin(leaf, me)
    for k, m in enumerate(members):
        piece = buf[k * block.shape[0]:(k + 1) * block.shape[0]]
        _take(out, _shift(leaf.src[m], dst_origin)).copy_(piece)


def _all_to_all(leaf, plan, x, out, me, axis, group) -> None:
    members = _members(plan.src.mesh, axis, me)
    itemsize = x.element_size()
    host = _stage_through_host(x, group)
    dev = torch.device("cpu") if host else x.device
    sends = [_intersect(leaf.src[me], leaf.dst[m]) for m in members]
    recvs = [_intersect(leaf.src[m], leaf.dst[me]) for m in members]
    sizes = [math.prod(_extent(b)) if b else 0 for b in sends]
    rsizes = [math.prod(_extent(b)) if b else 0 for b in recvs]
    inp = torch.empty(sum(sizes), dtype=x.dtype, device=dev)
    res = torch.empty(sum(rsizes), dtype=x.dtype, device=dev)
    _note_buffer(max(inp.numel(), res.numel()) * itemsize)
    at = 0
    for m, box, k in zip(members, sends, sizes):
        if box is not None:
            inp[at:at + k].view(_extent(box)).copy_(
                _take(x, _shift(box, leaf.origin[me])))
            if m != me:
                _record_sent(k * itemsize)
        at += k
    if host:
        counts["host_staged_bytes"] += (inp.numel() + res.numel()) * itemsize
    comm.all_to_all(res, inp, group)    # equal pieces: even boxes
    dst_origin = _dst_origin(leaf, me)
    at = 0
    for box, k in zip(recvs, rsizes):
        if box is not None:
            _take(out, _shift(box, dst_origin)).copy_(
                res[at:at + k].view(_extent(box)))
        at += k


def _slabs(size: int, n: int) -> List[Tuple[int, int]]:
    per = -(-size // n)
    return [(lo, min(size, lo + per)) for lo in range(0, size, per)]


def _chunked(leaf, plan, step, x, out, me, budget) -> None:
    """Stream the exchange along ``step.chunk_dim``, one slab at a time,
    through one staging buffer: pinned host memory for a host source on
    the card or for a gloo group's card tensors."""
    dim = step.chunk_dim
    size = plan.shape[dim]
    itemsize = out.element_size() if out is not None else x.element_size()
    host_src = (leaf.host and out is not None and out.device.type == "cuda"
                and x.device.type == "cpu")
    if leaf.host and not host_src:   # the source is where the block goes
        _copy_local(leaf, x, out, me, leaf.moves)
        return

    def slab_moves(lo, hi):
        cut_moves = []
        for p, q, box in leaf.moves:
            cut = list(box)
            cut[dim] = (max(box[dim][0], lo), min(box[dim][1], hi))
            if cut[dim][0] < cut[dim][1]:
                cut_moves.append((p, q, tuple(cut)))
        return cut_moves

    def staged(moves) -> Dict[int, int]:
        """Bytes each rank puts through its staging buffer."""
        per: Dict[int, int] = {}
        for p, q, box in moves:
            if p != q:
                ranks = (p, q)
            elif leaf.host:      # a host source's piece goes through it
                ranks = (q,)
            else:
                continue
            for r in ranks:
                per[r] = per.get(r, 0) + _nbytes(box, itemsize)
        return per

    n = step.chunks
    if budget is not None:
        while n < size and max(max(staged(slab_moves(*s)).values(), default=0)
                               for s in _slabs(size, n)) > budget:
            n = min(size, max(n + 1, math.ceil(n * 1.25)))
    slabs = _slabs(size, n)
    need = max(staged(slab_moves(*s)).get(me, 0) for s in slabs) // itemsize
    if need == 0:
        _copy_local(leaf, x, out, me, leaf.moves)
        return
    card = out if out is not None else x
    pinned = host_src or _stage_through_host(card)
    staging = torch.empty(need, dtype=card.dtype,
                          device="cpu" if pinned else card.device,
                          pin_memory=pinned)
    _note_buffer(need * itemsize, staging=True)
    for lo, hi in slabs:
        moves = slab_moves(lo, hi)
        if not leaf.host:
            _p2p(leaf, x, out, me, moves, staging=staging)
            continue
        # a host source: this rank's piece of the slab through the buffer
        for p, q, box in moves:
            if q != me:
                continue
            k = math.prod(_extent(box))
            buf = staging[:k].view(_extent(box))
            buf.copy_(_take(x, box))
            _take(out, _shift(box, _dst_origin(leaf, me))).copy_(
                buf, non_blocking=True)
            counts["host_staged_bytes"] += k * itemsize
            # the buffer is refilled next: wait for the copy out of it
            torch.cuda.current_stream(out.device).synchronize()


# -- the public surface -------------------------------------------------------
def _target_device(plan: LeafPlan, x):
    device = getattr(plan.dst.mesh, "device", None)
    if device is not None:
        return torch.device(device)
    return x.device if x is not None else torch.device("cpu")


@torch.no_grad()
def execute_plan(x, plan: LeafPlan, *, out: Optional[torch.Tensor] = None,
                 name: Optional[str] = None):
    """Run one leaf's schedule on this rank; bit-exact.

    ``x`` is this rank's block of ``plan.src`` (a DTensor, its local
    tensor, or the whole tensor for a host source; None where the rank
    holds none). Returns this rank's block of ``plan.dst``, written into
    ``out`` when given (in place: its storage is kept), ``x`` itself when
    it is that block already (no ``out``), or None on a rank outside the
    destination. For a plan with a ``region``, ``x`` is the
    rank's block of the whole tensor the leaf is a window of. ``name``
    names the leaf in errors.
    """
    if not plan.steps:   # no target: the leaf passes through
        return x
    if x is not None:
        x = _local(x)
    if x is not None and not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    step = plan.steps[0]
    leaf = _Leaf(plan, name)
    me = _me(plan.dst.mesh, plan.src.mesh if plan.src is not None else None)
    if me in leaf.src and x is None:
        raise ValueError(f"{name or 'leaf'}: rank {me} holds a block of the "
                         "source, got None")
    if me not in leaf.dst and me not in leaf.src:
        return None
    measure = (measure_peaks and torch.cuda.is_available()
               and _target_device(plan, x).type == "cuda")
    if measure:
        # resident before the move: the source block and a given out
        device = _target_device(plan, x)
        held = sum(t.numel() * t.element_size() for t in {
            id(t): t for t in (x, out) if t is not None}.values()
            if t.device.type == "cuda")
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    if me in leaf.dst:
        shape = _extent(leaf.dst[me])
        device = _target_device(plan, x)
        if (out is None and x is not None and plan.region is None
                and leaf.src.get(me) == leaf.dst[me] and x.device == device
                and x.is_contiguous() and not leaf.host):
            out = x     # the rank's block is its destination block: alias
        elif out is None:
            out = torch.empty(shape, dtype=plan.dtype, device=device)
        elif tuple(out.shape) != shape or out.dtype != plan.dtype:
            raise ValueError(f"{name or 'leaf'}: out is {tuple(out.shape)}/"
                             f"{out.dtype}, the block is {shape}/{plan.dtype}")
    remote = any(p != q for p, q, _ in leaf.moves)
    collective = None
    if (remote and step.op in ("all_gather", "all_to_all")
            and plan.region is None):
        collective = _mesh_group(plan, step.op)
    if collective is not None and step.op == "all_gather":
        _all_gather(leaf, plan, x, out, me, *collective)
    elif collective is not None:
        _all_to_all(leaf, plan, x, out, me, *collective)
    elif step.chunks > 1:
        _chunked(leaf, plan, step, x, out, me, step.staging_bytes)
    elif remote:
        _p2p(leaf, x, out, me, leaf.moves)
    else:
        _copy_local(leaf, x, out, me, leaf.moves)
    counts["leaves"] += 1
    if measure:
        torch.cuda.synchronize(device)
        peak = held + torch.cuda.max_memory_allocated(device) - base
        counts["measured_peak_bytes"] = max(counts["measured_peak_bytes"],
                                            peak)
        sizes = dict(plan.dst.mesh.shape)
        leaf_peaks.append({
            "name": name, "op": step.op, "dst_sharded": any(
                math.prod(sizes[a] for a in axes) > 1
                for axes in plan.dst.spec),
            "bytes_moved": plan.cost.bytes_moved,
            "peak_bytes": plan.cost.peak_bytes,
            "naive_gather_bytes": plan.cost.naive_gather_bytes,
            "measured_peak_bytes": peak})
    return out


def redistribute(x, dst: Sharding, *, max_staging_bytes: Optional[int] = None,
                 name: Optional[str] = None):
    """Move one tensor to ``dst`` through a planned schedule (bit-exact).

    ``x`` is a DTensor or a :class:`Placed` block (its placement is the
    source; a rank that holds none passes a :class:`Placed` without a
    block), or the whole tensor every rank holds.
    """
    shape, dtype, src = leaf_meta(x)
    plan = plan_transfer(shape, dtype, src, dst,
                         max_staging_bytes=max_staging_bytes)
    return execute_plan(x, plan, name=name)


def redistribute_tree(
    tree,
    dst_shardings,
    *,
    max_staging_bytes: Optional[int] = None,
    plan: Optional[TreePlan] = None,
) -> Any:
    """Move a tree onto ``dst_shardings``, one leaf at a time.

    ``tree``'s leaves are DTensors, :class:`Placed` blocks or whole
    tensors every rank holds (None where a rank holds nothing of a leaf:
    pass ``plan``, made from the global shapes, then).
    ``dst_shardings`` is a matching tree of :class:`Sharding`; ``None``
    entries leave their leaf as it is. A precomputed ``plan`` (from
    :func:`plan_tree`) skips replanning for repeated transfers.
    """
    paths_leaves = flatten(tree)
    if plan is None:
        if any(x is None for _, x in paths_leaves):
            raise ValueError("a rank without a block of a leaf needs the "
                             "plan of the global shapes")
        plan = plan_tree(tree, dst_shardings,
                         max_staging_bytes=max_staging_bytes)
    out = [execute_plan(x, p, name="/".join(map(str, path)))
           for (path, x), p in zip(paths_leaves, plan.leaves)]
    return unflatten(tree, out)
