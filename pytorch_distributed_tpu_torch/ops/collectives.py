"""Collectives over a mesh axis: the op set of the JAX package's
``ops/collectives.py``, per rank.

The reference wraps ``jax.lax`` collectives for use inside ``shard_map``,
where a mesh axis name is bound. The port's code already runs per rank
(one process each), so every function here takes the mesh and the axis
(a name, or a tuple of names whose group spans them all, as
``DeviceMesh.get_group`` makes it) and runs on that axis's process group,
through ``parallel.comm`` (counted, with the bytes and dtype of each
call). ``shard_map`` has no counterpart. The functions return new tensors
and leave their input as it is, as the reference's do.

``all_reduce``'s ``op`` is one of sum, mean (avg), max, min, prod;
``reduce_scatter``'s sum or mean. ``permute``'s ``perm`` is (source,
destination) pairs of the axis's ranks; a rank that receives nothing gets
zeros, as ``lax.ppermute`` gives.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.parallel import comm

__all__ = [
    "all_reduce",
    "all_gather",
    "reduce_scatter",
    "broadcast",
    "all_to_all",
    "permute",
    "send_to",
    "recv_from",
    "barrier",
    "axis_index",
    "axis_size",
]

_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
        "avg": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT,
        "product": dist.ReduceOp.PRODUCT}


def axis_index(mesh, axis) -> int:
    """This rank's coordinate along ``axis`` (``dist.get_rank(group)``)."""
    return mesh.get_local_rank(axis)


def axis_size(mesh, axis) -> int:
    """Ranks along ``axis`` (``dist.get_world_size(group)``)."""
    return mesh.size(axis)


def all_reduce(x: torch.Tensor, mesh, axis, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over the axis (``dist.all_reduce``)."""
    if op not in _OPS:
        raise ValueError(f"unknown reduce op {op!r}")
    out = comm.all_reduce(x.clone(), mesh.get_group(axis), _OPS[op])
    if op in ("mean", "avg"):
        out = out / mesh.size(axis)
    return out


def all_gather(x: torch.Tensor, mesh, axis, *, gather_dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` along ``gather_dim`` in rank order
    (``all_gather_into_tensor``); ``tiled=False`` stacks a new dim of the
    axis's size there instead."""
    n = mesh.size(axis)
    src = x.movedim(gather_dim, 0).contiguous() if tiled else x[None]
    out = src.new_empty((n * src.shape[0],) + src.shape[1:])
    comm.all_gather(out, src.contiguous(), mesh.get_group(axis))
    return out.movedim(0, gather_dim)


def reduce_scatter(x: torch.Tensor, mesh, axis, *, op: str = "sum",
                   scatter_dim: int = 0) -> torch.Tensor:
    """The sum (or mean) over the axis, each rank keeping its block along
    ``scatter_dim``, which must divide by the axis size
    (``reduce_scatter_tensor``)."""
    if op not in ("sum", "mean", "avg"):
        raise ValueError("reduce_scatter supports sum/mean")
    n = mesh.size(axis)
    src = x.movedim(scatter_dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter dim {scatter_dim} "
                         f"({src.shape[0]}) not divisible by {n}")
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    comm.reduce_scatter(out, src, mesh.get_group(axis))
    if op != "sum":
        out = out / n
    return out.movedim(0, scatter_dim)


def broadcast(x: torch.Tensor, mesh, axis, *, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank of the axis (``dist.broadcast``)."""
    n = mesh.size(axis)
    if not 0 <= src < n:
        raise ValueError(f"broadcast src {src} out of range for axis size {n}")
    return comm.broadcast(x.clone(), mesh.get_group(axis), src)


def all_to_all(x: torch.Tensor, mesh, axis, *, split_dim: int,
               concat_dim: int, tiled: bool = True) -> torch.Tensor:
    """``x`` cut into the axis size's blocks along ``split_dim``, block
    ``j`` sent to rank ``j``, the received blocks joined along
    ``concat_dim`` in rank order (``lax.all_to_all``; ``tiled=False``:
    ``split_dim`` has the axis's size, is dropped, and the received blocks
    are stacked as a new ``concat_dim``)."""
    n = mesh.size(axis)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all split dim {split_dim} "
                         f"({x.shape[split_dim]}) not divisible by {n}")
    blocks = torch.stack(x.chunk(n, split_dim)).contiguous()
    out = torch.empty_like(blocks)
    comm.all_to_all(out, blocks, mesh.get_group(axis))
    if tiled:
        return torch.cat(out.unbind(0), concat_dim)
    return torch.stack([b.squeeze(split_dim) for b in out.unbind(0)],
                       concat_dim)


def permute(x: torch.Tensor, mesh, axis,
            perm: Sequence[tuple]) -> torch.Tensor:
    """``lax.ppermute``: for each (source, destination) pair, the source's
    ``x`` lands on the destination; a rank no pair sends to gets zeros."""
    me = mesh.get_local_rank(axis)
    if (me, me) in perm:      # a rank's own value stays, no wire
        return x.clone()
    sends = [(x.contiguous(), dst) for src, dst in perm if src == me]
    srcs = [src for src, dst in perm if dst == me]
    if len(srcs) > 1:
        raise ValueError(f"rank {me} receives from several ranks: {srcs}")
    out = torch.zeros_like(x)
    comm.p2p(mesh.get_group(axis), sends=sends,
             recvs=[(out, srcs[0])] if srcs else ())
    return out


def _ring_perm(n: int, shift: int):
    return [(i, (i + shift) % n) for i in range(n)]


def send_to(x: torch.Tensor, mesh, axis, *,
            dst_offset: int = 1) -> torch.Tensor:
    """Ring shift: every rank's ``x`` moves ``dst_offset`` ranks forward,
    so rank ``i`` gets rank ``i - dst_offset``'s."""
    return permute(x, mesh, axis, _ring_perm(mesh.size(axis), dst_offset))


def recv_from(x: torch.Tensor, mesh, axis, *,
              src_offset: int = 1) -> torch.Tensor:
    """The mirror of :func:`send_to`: rank ``i`` gets rank ``i +
    src_offset``'s ``x``."""
    return permute(x, mesh, axis, _ring_perm(mesh.size(axis), -src_offset))


def barrier(mesh, axis) -> torch.Tensor:
    """Every rank of the axis reaches this point before any leaves it.
    Returns a zero 0-d int32 tensor, as the reference's token is."""
    comm.barrier(mesh.get_group(axis))
    return torch.zeros((), dtype=torch.int32, device=mesh.device)
