"""Device meshes of the port, over ``torch.distributed.device_mesh``.

Port of ``pytorch_distributed_tpu/mesh.py`` (``DeviceMesh``,
``init_device_mesh``). In the JAX package a mesh is a grid of devices that
one program spans; here it is a grid of ranks, one process each, over the
default process group (``distributed.init_process_group``), with one
process group per axis: the group that a collective over that axis runs
on, and one per tuple of axes that a strategy splits the batch over.
``init_hybrid_mesh`` lays the ranks out node-major, the DCN axes
outermost (the reference's multi-slice mesh). A mesh may also span a
subset of the ranks (``init_device_mesh(..., ranks=...)``: the target of
a resize); every rank of the world builds it, and the ranks outside it
hold no coordinate on it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh as _TorchMesh
from torch.distributed.device_mesh import init_device_mesh as _torch_mesh

from pytorch_distributed_tpu_torch import distributed as pdist

__all__ = ["DeviceMesh", "init_device_mesh", "init_hybrid_mesh"]


class DeviceMesh:
    """An N-D grid of ranks with named axes.

    ``mesh.axis_names``, ``mesh.shape`` (``{axis: size}``),
    ``mesh.size(axis)``, ``mesh.get_group(axis)`` (the process group of
    this rank's line along ``axis``), ``mesh.get_local_rank(axis)`` (this
    rank's coordinate on it), ``mesh.ranks`` (the global ranks it spans,
    row-major) and ``mesh.device`` (the card, or the CPU).
    ``axis`` may also be a tuple of axes: its size is the product, its
    coordinate is row-major over the axes in the order given (the order
    in which the reference's ``P(('dp', 'fsdp'))`` splits a dim), and its
    group spans them all. The first call for a tuple of several axes
    creates the group, a collective call: every rank makes it, in the same
    order (the strategies do, when they are built).
    """

    def __init__(self, torch_mesh, device: torch.device):
        self._mesh = torch_mesh
        self.device = device
        self._flat: dict = {}

    @property
    def axis_names(self) -> tuple:
        return tuple(self._mesh.mesh_dim_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self._mesh.mesh.shape))

    @property
    def ranks(self) -> tuple:
        return tuple(int(r) for r in self._mesh.mesh.flatten().tolist())

    def size(self, axis) -> int:
        return math.prod(self._mesh.size(self._dim(a)) for a in _axes(axis))

    def get_group(self, axis) -> dist.ProcessGroup:
        axes = _axes(axis)
        if len(axes) == 1:
            return self._mesh.get_group(self._dim(axes[0]))
        if axes not in self._flat:
            for a in axes:
                self._dim(a)
            if len(set(axes)) != len(axes):
                raise ValueError(f"repeated axis in {axes}")
            self._flat[axes] = self._mesh[axes]._flatten(
                "_".join(axes)).get_group()
        return self._flat[axes]

    def get_local_rank(self, axis) -> int:
        rank = 0
        for a in _axes(axis):
            rank = (rank * self._mesh.size(self._dim(a))
                    + self._mesh.get_local_rank(self._dim(a)))
        return rank

    def _dim(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} not in mesh {self.axis_names}")
        return self.axis_names.index(axis)

    def __repr__(self):
        dims = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        return f"DeviceMesh({dims}, device={self.device})"


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def init_device_mesh(
    mesh_shape: Sequence[int],
    axis_names: Sequence[str],
    *,
    ranks: Optional[Sequence[int]] = None,
) -> DeviceMesh:
    """A mesh over every rank of the default process group, in rank order
    (torch ``init_device_mesh``), or over ``ranks`` (row-major), a subset
    of them: every rank of the world calls it, in the same order as its
    other group creations. The mesh runs on the group's device: the card
    unless the group was initialised with ``device="cpu"``."""
    device = pdist.get_device()
    n = dist.get_world_size()
    shape = tuple(mesh_shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"{len(shape)} mesh dims but {len(axis_names)} names")
    want = n if ranks is None else len(ranks)
    if math.prod(shape) != want:
        raise ValueError(f"mesh_shape {tuple(shape)} needs {math.prod(shape)} "
                         f"ranks, {'the group has' if ranks is None else 'got'}"
                         f" {want}")
    if ranks is None:
        torch_mesh = _torch_mesh(device.type, shape,
                                 mesh_dim_names=tuple(axis_names))
    else:
        if len(set(ranks)) != len(ranks) or not all(
                0 <= int(r) < n for r in ranks):
            raise ValueError(f"ranks {list(ranks)} are not distinct ranks of "
                             f"a world of {n}")
        torch_mesh = _TorchMesh(device.type, torch.tensor(
            [int(r) for r in ranks]).reshape(shape),
            mesh_dim_names=tuple(axis_names))
    return DeviceMesh(torch_mesh, device)


def init_hybrid_mesh(
    ici_mesh_shape: Sequence[int],
    dcn_mesh_shape: Sequence[int],
    axis_names: Sequence[str],
) -> DeviceMesh:
    """Multi-node mesh: the DCN axes outermost, the ICI axes innermost
    (the reference's ``init_hybrid_mesh``). One node is a "slice" of
    ``prod(ici_mesh_shape)`` consecutive ranks, so with ranks numbered
    node-major (torchrun's order) an ICI axis stays inside a node and a
    DCN axis crosses nodes. ``axis_names`` names the DCN axes first.
    HSDP (torch FSDP ``HYBRID_SHARD``: shard inside a node, replicate
    across nodes) is ``init_hybrid_mesh((per_node,), (n_nodes,), ("dcn",
    "fsdp"))`` under ``HybridShard``."""
    shape = tuple(dcn_mesh_shape) + tuple(ici_mesh_shape)
    return init_device_mesh(shape, axis_names)
