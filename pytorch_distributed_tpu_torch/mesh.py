"""Device meshes of the port, over ``torch.distributed.device_mesh``.

Port of ``pytorch_distributed_tpu/mesh.py`` (``DeviceMesh``,
``init_device_mesh``). In the JAX package a mesh is a grid of devices that
one program spans; here it is a grid of ranks, one process each, over the
default process group (``distributed.init_process_group``), with one
process group per axis: the group that a collective over that axis runs
on. ``init_hybrid_mesh`` waits for multi-slice work (ROADMAP A.4).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh as _torch_mesh

from pytorch_distributed_tpu_torch import distributed as pdist

__all__ = ["DeviceMesh", "init_device_mesh"]


class DeviceMesh:
    """An N-D grid of ranks with named axes.

    ``mesh.axis_names``, ``mesh.shape`` (``{axis: size}``),
    ``mesh.size(axis)``, ``mesh.get_group(axis)`` (the process group of
    this rank's line along ``axis``), ``mesh.get_local_rank(axis)`` (this
    rank's coordinate on it) and ``mesh.device`` (the card, or the CPU).
    """

    def __init__(self, torch_mesh, device: torch.device):
        self._mesh = torch_mesh
        self.device = device

    @property
    def axis_names(self) -> tuple:
        return tuple(self._mesh.mesh_dim_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self._mesh.mesh.shape))

    def size(self, axis: str) -> int:
        return self._mesh.size(self._dim(axis))

    def get_group(self, axis: str) -> dist.ProcessGroup:
        return self._mesh.get_group(self._dim(axis))

    def get_local_rank(self, axis: str) -> int:
        return self._mesh.get_local_rank(self._dim(axis))

    def _dim(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} not in mesh {self.axis_names}")
        return self.axis_names.index(axis)

    def __repr__(self):
        dims = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        return f"DeviceMesh({dims}, device={self.device})"


def init_device_mesh(
    mesh_shape: Sequence[int],
    axis_names: Sequence[str],
) -> DeviceMesh:
    """A mesh over every rank of the default process group, in rank order
    (torch ``init_device_mesh``). The mesh runs on the group's device: the
    card unless the group was initialised with ``device="cpu"``."""
    device = pdist.get_device()
    n = dist.get_world_size()
    shape = tuple(mesh_shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"{len(shape)} mesh dims but {len(axis_names)} names")
    if math.prod(shape) != n:
        raise ValueError(f"mesh_shape {tuple(shape)} needs {math.prod(shape)} "
                         f"ranks, the group has {n}")
    torch_mesh = _torch_mesh(device.type, shape,
                             mesh_dim_names=tuple(axis_names))
    return DeviceMesh(torch_mesh, device)
