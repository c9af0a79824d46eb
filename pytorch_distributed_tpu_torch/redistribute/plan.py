"""Redistribution planner: (mesh, spec) -> (mesh', spec') transfer schedules.

Port of ``pytorch_distributed_tpu/redistribute/plan.py``. Planning is pure
Python over shapes, dtypes and placements: no collective, no process
group, so plans are deterministic, cheap enough to build per restore, and
testable on the CPU.

A placement is a :class:`Sharding`: a mesh and, for each dim of the
tensor, the tuple of mesh axes it is split over (the reference's
``NamedSharding(mesh, P(...))`` after ``_norm_spec``); several axes on one
dim split it row-major over them, in the order given. ``None`` in place of
a ``Sharding`` is a host-resident tensor: every participating rank holds
the whole of it, on the CPU or the card. The mesh needs to answer four
things only: ``axis_names``, ``shape`` (``{axis: size}``), ``size(axis)``
and the global ranks it spans, row-major (``ranks``; a mesh without that
attribute spans ``range(prod(shape))``). So the port's ``DeviceMesh``
(also over a subset of the ranks) and a stand-in with sizes alone both
plan. The device set of the reference is the mesh's set of ranks.

The schedule for one leaf is a tuple of :class:`TransferStep`, each naming
the collective it lowers to and the placement the data has after it. Every
transfer is one step: an ``all_gather`` when dims only lose sharding, a
``dynamic_slice`` when they only gain it, an ``all_to_all`` when sharding
moves between dims, a ``device_put`` across rank sets (or a relabel within
one), a ``noop`` for the same placement. The cost model is the
reference's, number for number: the peak of a direct transition is the
source shard plus the destination shard, against the naive
gather-then-slice's source shard plus the whole tensor
(``naive_gather_bytes``), and a copy that leaves the source's rank set can
be chunked along a dim the destination keeps whole so that at most
``max_staging_bytes`` is in flight. The bytes the executor really sends
are counted apart (``executor.counts``): the model assumes uncorrelated
placement where two placements differ.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "OPS",
    "LocalMesh",
    "Sharding",
    "TransferStep",
    "TransferCost",
    "LeafPlan",
    "TreePlan",
    "plan_transfer",
    "plan_tree",
]

# ops a step can lower to; "device_put" covers cross-rank-set copies and
# pure axis relabels, everything else is an in-mesh collective
OPS = ("noop", "all_gather", "all_to_all", "dynamic_slice", "device_put")


def _entry(e) -> Tuple[str, ...]:
    if e is None:
        return ()
    if isinstance(e, (tuple, list)):
        return tuple(e)
    return (e,)


def mesh_ranks(mesh) -> Tuple[int, ...]:
    """The global ranks ``mesh`` spans, row-major over its axes."""
    ranks = getattr(mesh, "ranks", None)
    if ranks is not None:
        return tuple(int(r) for r in ranks)
    return tuple(range(math.prod(dict(mesh.shape).values())))


def _mesh_key(mesh):
    shape = dict(mesh.shape)
    return (tuple(mesh.axis_names), tuple(shape[a] for a in mesh.axis_names),
            mesh_ranks(mesh))


class LocalMesh:
    """A mesh of this one rank and no axes: ``Sharding(LocalMesh(device))``
    is a tensor held whole by one rank off any mesh (the reference's
    ``SingleDeviceSharding``)."""

    axis_names = ()

    def __init__(self, device, rank: Optional[int] = None):
        import torch.distributed as dist

        self.device = torch.device(device)
        if rank is None:
            rank = (dist.get_rank() if dist.is_available()
                    and dist.is_initialized() else 0)
        self.shape = {}
        self.ranks = (int(rank),)


class Sharding:
    """``mesh`` and ``spec``: for each dim, the mesh axes that split it
    (``None``, one axis name, or a tuple of names; the reference's
    ``PartitionSpec`` entries). Equal when the meshes span the same ranks
    in the same layout and the specs are equal entry for entry (as
    ``NamedSharding.__eq__``: a trailing ``None`` makes another spec)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: Sequence = ()):
        self.mesh = mesh
        self.spec = tuple(_entry(e) for e in spec)
        names = tuple(mesh.axis_names)
        used = [a for e in self.spec for a in e]
        for a in used:
            if a not in names:
                raise ValueError(f"axis {a!r} not in mesh {names}")
        if len(set(used)) != len(used):
            raise ValueError(f"an axis appears twice in {self.spec}")

    @classmethod
    def from_placement(cls, mesh, placement: Dict[str, int], ndim: int
                       ) -> "Sharding":
        """The sharding of a ``{axis: dim}`` placement (the strategies'
        ``placement``/``param_pspec`` answers; ``{}`` is whole): each dim
        takes its axes in mesh order."""
        spec = [[] for _ in range(ndim)]
        for axis in mesh.axis_names:
            if axis in placement:
                spec[placement[axis]].append(axis)
        extra = set(placement) - set(mesh.axis_names)
        if extra:
            raise ValueError(f"axes {sorted(extra)} not in mesh "
                             f"{tuple(mesh.axis_names)}")
        return cls(mesh, [tuple(s) for s in spec])

    @property
    def ranks(self) -> Tuple[int, ...]:
        return mesh_ranks(self.mesh)

    def __eq__(self, other):
        if not isinstance(other, Sharding):
            return NotImplemented
        return (self.spec == other.spec
                and (self.mesh is other.mesh
                     or _mesh_key(self.mesh) == _mesh_key(other.mesh)))

    def __hash__(self):
        return hash((self.spec, _mesh_key(self.mesh)))

    def __repr__(self):
        dims = ", ".join(f"{a}={s}" for a, s in dict(self.mesh.shape).items())
        return f"Sharding(mesh({dims}), {self.spec})"


@dataclasses.dataclass(frozen=True)
class TransferStep:
    """One schedule step: move the leaf to ``target`` via ``op``.

    ``chunks > 1`` marks a staged cross-rank-set copy split along
    ``chunk_dim`` (a dim unsharded in the target) so the in-flight transfer
    buffer holds one chunk, not the whole destination shard;
    ``staging_bytes`` is the budget it was planned under (the executor
    takes more chunks where a rank's sends and receives would not fit).
    """

    op: str
    target: Any  # Sharding
    chunks: int = 1
    chunk_dim: int = 0
    staging_bytes: Optional[int] = None

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown op {self.op!r}; one of {OPS}")


@dataclasses.dataclass(frozen=True)
class TransferCost:
    """Per-rank cost model for one leaf transfer.

    bytes_moved:        bytes that cross a rank boundary, per rank
    peak_bytes:         max live bytes on any rank at any step
                        (src shard + dst shard + in-flight staging chunk)
    naive_gather_bytes: peak of the hand-rolled gather-then-slice baseline
                        (src shard + one full replica)
    """

    bytes_moved: int
    peak_bytes: int
    naive_gather_bytes: int

    def __add__(self, other: "TransferCost") -> "TransferCost":
        # tree aggregate: leaves move one at a time, so peaks max (the
        # resident shards of other leaves are the caller's to count)
        return TransferCost(
            bytes_moved=self.bytes_moved + other.bytes_moved,
            peak_bytes=max(self.peak_bytes, other.peak_bytes),
            naive_gather_bytes=max(self.naive_gather_bytes,
                                   other.naive_gather_bytes),
        )


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    src: Any  # Sharding or None (host-resident source)
    dst: Any  # Sharding (None: no target, the leaf passes through)
    steps: Tuple[TransferStep, ...]
    cost: TransferCost
    #: ``(full_shape, offset)``: the leaf is the box of ``shape`` at
    #: ``offset`` of a tensor of ``full_shape`` placed by ``src`` (the q, k
    #: or v rows of a fused projection); None: the leaf is that tensor
    region: Any = None

    @property
    def ops(self) -> Tuple[str, ...]:
        return tuple(s.op for s in self.steps)


@dataclasses.dataclass(frozen=True)
class TreePlan:
    plans: Any  # the tree's structure, a LeafPlan at each leaf
    cost: TransferCost

    @property
    def leaves(self):
        return [p for _, p in flatten(self.plans)]


# -- trees: dicts (keys sorted, as jax.tree_util), lists and tuples ---------
def flatten(tree, prefix=()):
    """``[(path, leaf)]`` of a tree of dicts, lists and tuples; anything
    else (``None`` included) is a leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(flatten(v, prefix + (i,)))
        return out
    return [(prefix, tree)]


def unflatten(like, leaves):
    """``like``'s structure holding ``leaves`` in :func:`flatten`'s order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def leaves_up_to(tree, like):
    """``tree``'s subtrees at the leaf positions of ``like`` (as
    ``treedef.flatten_up_to``: a ``None`` in ``tree`` is one leaf)."""
    out = []
    for path, _ in flatten(like):
        node = tree
        for k in path:
            node = node[k]
        out.append(node)
    return out


# -- the cost model ---------------------------------------------------------
def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _itemsize(dtype) -> int:
    return torch.empty(0, dtype=_torch_dtype(dtype)).element_size()


def _norm_spec(sharding, ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """Per-dim tuple of mesh axis names, padded with () to ndim."""
    spec = tuple(sharding.spec) if sharding is not None else ()
    return spec + ((),) * (ndim - len(spec))


def _dim_factors(sharding, ndim: int) -> Tuple[int, ...]:
    """Number of shards along each dim (1 everywhere for the host)."""
    if sharding is None:
        return (1,) * ndim
    sizes = dict(sharding.mesh.shape)
    return tuple(math.prod(sizes[a] for a in axes)
                 for axes in _norm_spec(sharding, ndim))


def _total_bytes(shape: Sequence[int], dtype) -> int:
    return math.prod(shape) * _itemsize(dtype)


def _shard_bytes(shape: Sequence[int], dtype, sharding) -> int:
    """Per-rank bytes of one shard (the whole leaf for the host)."""
    if sharding is None:
        return _total_bytes(shape, dtype)
    factors = _dim_factors(sharding, len(shape))
    dims = [-(-int(d) // f) for d, f in zip(shape, factors)]  # ceil div
    return math.prod(dims) * _itemsize(dtype)


def _device_ids(sharding) -> frozenset:
    if sharding is None:
        return frozenset()
    return frozenset(sharding.ranks)


def boxes(shape: Sequence[int], sharding) -> Dict[int, Tuple]:
    """``{rank: ((start, stop) per dim)}``: the index box each rank of the
    sharding's mesh holds (ceil-sized blocks, the last one short, as
    JAX's ``devices_indices_map``)."""
    ndim = len(shape)
    mesh = sharding.mesh
    sizes = dict(mesh.shape)
    names = tuple(mesh.axis_names)
    spec = _norm_spec(sharding, ndim)
    out = {}
    for flat, rank in enumerate(mesh_ranks(mesh)):
        coords, rest = {}, flat
        for a in reversed(names):
            coords[a] = rest % sizes[a]
            rest //= sizes[a]
        box = []
        for d, axes in enumerate(spec):
            index, factor = 0, 1
            for a in axes:
                index = index * sizes[a] + coords[a]
                factor *= sizes[a]
            block = -(-int(shape[d]) // factor)
            lo = min(index * block, int(shape[d]))
            box.append((lo, min(lo + block, int(shape[d]))))
        out[rank] = tuple(box)
    return out


def intersect(a, b):
    """The common box of two boxes, or None."""
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1) in zip(a, b))
    return out if all(lo < hi for lo, hi in out) else None


def extent(box) -> Tuple[int, ...]:
    return tuple(hi - lo for lo, hi in box)


def shift(box, origin):
    return tuple((lo - o, hi - o) for (lo, hi), o in zip(box, origin))


def region_boxes(shape, sharding, region) -> Dict[int, Tuple]:
    """``{rank: box}`` (leaf coordinates) of the ranks whose block of
    ``sharding`` over ``region``'s full shape meets the leaf's window."""
    full, offset = region
    window = tuple((o, o + n) for o, n in zip(offset, shape))
    out = {}
    for r, box in boxes(full, sharding).items():
        cut = intersect(box, window)
        if cut is not None:
            out[r] = shift(cut, offset)
    return out


def _same_shardings(src, dst, shape) -> bool:
    """The reference's ``is_equivalent_to``: the same ranks in the same
    order, each holding the same box."""
    if src is None or dst is None:
        return False
    if src == dst:
        return True
    return (src.ranks == dst.ranks
            and boxes(shape, src) == boxes(shape, dst))


def _classify(src, dst, ndim: int) -> str:
    """Collective a same-rank-set transition lowers to."""
    s_axes = _norm_spec(src, ndim)
    d_axes = _norm_spec(dst, ndim)
    s_fac = _dim_factors(src, ndim)
    d_fac = _dim_factors(dst, ndim)
    loses = any(sf > 1 and sa != da
                for sa, da, sf in zip(s_axes, d_axes, s_fac))
    gains = any(df > 1 and sa != da
                for sa, da, df in zip(s_axes, d_axes, d_fac))
    if loses and gains:
        return "all_to_all"
    if loses:
        return "all_gather"
    if gains:
        return "dynamic_slice"
    return "device_put"  # axis relabel / mesh re-view


def _local_fraction(src, dst, shape) -> float:
    """Fraction of a rank's dst shard assumed resident on that rank: per
    dim, identical axes keep it all, differing axes keep 1/src_factor
    (uncorrelated placement)."""
    ndim = len(shape)
    s_axes = _norm_spec(src, ndim)
    d_axes = _norm_spec(dst, ndim)
    s_fac = _dim_factors(src, ndim)
    frac = 1.0
    for sa, da, sf in zip(s_axes, d_axes, s_fac):
        if sa != da:
            frac /= sf
    return frac


def _pick_chunk_dim(shape, dst, ndim: int) -> Optional[int]:
    """Largest dim unsharded in dst (chunk boundaries then never cut a
    dst shard)."""
    d_fac = _dim_factors(dst, ndim)
    best = None
    for d in range(ndim):
        if d_fac[d] == 1 and shape[d] > 1:
            if best is None or shape[d] > shape[best]:
                best = d
    return best


def plan_transfer(
    shape: Sequence[int],
    dtype,
    src,
    dst,
    *,
    max_staging_bytes: Optional[int] = None,
    region=None,
) -> LeafPlan:
    """Plan one leaf's (mesh, spec) -> (mesh', spec') transfer.

    Args:
      shape, dtype: the global leaf (a torch or numpy dtype).
      src: source :class:`Sharding`, or None for a host-resident source.
      dst: target :class:`Sharding`.
      max_staging_bytes: optional cap on the in-flight transfer buffer for
        cross-rank-set copies; the plan chunks along a dim the target keeps
        whole. In-mesh collectives need no staging and ignore it.
      region: ``(full_shape, offset)`` when the leaf is a window of a
        tensor of ``full_shape`` placed by ``src`` (a fused projection's q,
        k or v rows). The window's blocks need not be one sharding's, so
        such a plan reads its op and bytes off the ranks' boxes: the most
        any rank lacks of its destination block, its peak the largest
        window block plus the destination block (the port's extension;
        the reference has no such leaf).

    Returns a :class:`LeafPlan` whose ``cost`` is comparable against the
    ``naive_gather_bytes`` baseline (gather a full replica, then slice).
    """
    shape = tuple(int(d) for d in shape)
    dtype = _torch_dtype(dtype)
    ndim = len(shape)
    total = _total_bytes(shape, dtype)
    src_b = _shard_bytes(shape, dtype, src)
    dst_b = _shard_bytes(shape, dtype, dst)
    naive = src_b + total

    def plan(step, cost):
        return LeafPlan(shape, dtype, src, dst, steps=(step,), cost=cost,
                        region=region)

    itemsize = _itemsize(dtype)
    if region is not None and src is not None:
        held = region_boxes(shape, src, region)
        src_b = max((math.prod(extent(b)) for b in held.values()),
                    default=0) * itemsize
        naive = src_b + total
        if _device_ids(src) == _device_ids(dst):
            lack, whole_src = 0, True
            for q, d in boxes(shape, dst).items():
                have = intersect(held[q], d) if q in held else None
                got = math.prod(extent(have)) if have else 0
                lack = max(lack, (math.prod(extent(d)) - got) * itemsize)
                whole_src &= q not in held or intersect(held[q], d) == held[q]
            op = ("dynamic_slice" if lack == 0 else
                  "all_gather" if whole_src else "all_to_all")
            return plan(TransferStep(op, dst),
                        TransferCost(lack, src_b + dst_b, naive))

    if region is None and _same_shardings(src, dst, shape):
        # the same placement (noop), or the same boxes on another view of
        # the mesh: nothing moves, the result carries the dst sharding
        op = "noop" if src == dst else "device_put"
        return plan(TransferStep(op, dst), TransferCost(0, src_b, naive))

    if src is not None and _device_ids(src) == _device_ids(dst):
        # one in-mesh collective, no staging
        local = _local_fraction(src, dst, shape)
        moved = int(math.ceil(dst_b * (1.0 - local)))
        return plan(TransferStep(_classify(src, dst, ndim), dst),
                    TransferCost(moved, src_b + dst_b, naive))

    # cross-rank-set (or host -> mesh) copy: every dst byte crosses a
    # rank boundary and is staged; chunk to bound the staging
    chunks, chunk_dim, budget = 1, 0, None
    staging = dst_b
    if max_staging_bytes is not None and dst_b > max_staging_bytes:
        dim = _pick_chunk_dim(shape, dst, ndim)
        if dim is not None:
            want = -(-dst_b // max_staging_bytes)  # ceil
            chunks = min(shape[dim], max(1, int(want)))
            chunk_dim = dim
            staging = -(-dst_b // chunks)
            budget = int(max_staging_bytes)
    return plan(TransferStep("device_put", dst, chunks=chunks,
                             chunk_dim=chunk_dim, staging_bytes=budget),
                TransferCost(dst_b, src_b + dst_b + staging, naive))


def leaf_meta(x, src=None):
    """``(global shape, dtype, src sharding)`` of a tree leaf: a DTensor or
    an ``executor.Placed`` (a global shape and a sharding), a tensor or
    anything with ``shape`` and ``dtype`` (a global shape; ``src`` the
    caller's)."""
    from pytorch_distributed_tpu_torch.redistribute.executor import (
        Placed,
        dtensor_sharding,
    )

    if isinstance(x, Placed):
        return tuple(x.shape), x.dtype, x.sharding
    s = dtensor_sharding(x)
    if s is not None:
        return tuple(x.shape), x.dtype, s
    return tuple(x.shape), x.dtype, src


def plan_tree(
    tree,
    dst_shardings,
    *,
    src_shardings=None,
    max_staging_bytes: Optional[int] = None,
) -> TreePlan:
    """Plan a whole tree's transfer; leaves move one at a time.

    ``tree`` holds DTensors, ``Placed`` blocks, whole tensors or
    global-shape stand-ins (a ``torch.empty(..., device="meta")``, or
    anything with ``shape`` and ``dtype``); ``dst_shardings`` is a matching tree of target
    :class:`Sharding` (``None`` entries pass through as empty plans), and
    ``src_shardings`` one of the sources' (default: a DTensor's own, else
    host-resident). Aggregate cost: ``bytes_moved`` sums, ``peak_bytes``
    is the largest single-leaf peak.
    """
    paths_leaves = flatten(tree)
    leaves = [x for _, x in paths_leaves]
    src_list = (leaves_up_to(src_shardings, tree) if src_shardings is not None
                else [None] * len(leaves))
    dst_list = leaves_up_to(dst_shardings, tree)
    plan_leaves = []
    for x, s, d in zip(leaves, src_list, dst_list):
        shape, dtype, src = leaf_meta(x, s)
        if d is None:
            plan_leaves.append(LeafPlan(shape, _torch_dtype(dtype), src, None,
                                        steps=(), cost=TransferCost(0, 0, 0)))
        else:
            plan_leaves.append(plan_transfer(
                shape, dtype, src, d, max_staging_bytes=max_staging_bytes))
    cost = TransferCost(0, 0, 0)
    for p in plan_leaves:
        cost = cost + p.cost
    return TreePlan(plans=unflatten(tree, plan_leaves), cost=cost)
