"""The device mesh of a data-parallel run (port of alignq_tpu/dist/mesh.py).

The JAX package runs one process over N devices and lays them out as a
('data', 'model') mesh. The port runs one process per device, the PyTorch
way: the world of the default `torch.distributed` process group is the
mesh's data axis, and this rank's coordinate on it is its rank. A mesh of
one device needs no process group. A 'model' axis larger than 1 (tensor
parallelism) is described here, and refused by the trainers: it waits for
ROADMAP queue 1 item 3's tensor-parallel half.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch.distributed as dist

from alignq_tpu_torch.dist.collectives import BatchAxis


@dataclasses.dataclass(frozen=True)
class Mesh:
    """axes: the axis names, data first; sizes: each axis's size; group:
    the process group of the data axis (None for one device); rank: this
    process's coordinate on the data axis."""

    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    group: Optional[Any]
    rank: int

    @property
    def shape(self) -> Dict[str, int]:
        """axis name -> size, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axes, self.sizes))

    @property
    def n_data(self) -> int:
        return self.sizes[0]

    @property
    def n_model(self) -> int:
        return self.shape.get("model", 1)

    def batch_axis(self) -> Optional[BatchAxis]:
        """The data axis the batch is split over; None without a process
        group (a world of one process still reduces through its group)."""
        return BatchAxis(self.group, self.rank, self.n_data) if self.group is not None else None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Optional[Sequence[int]] = None, axes: Sequence[str] = ("data", "model")) -> Mesh:
    """A mesh over the world (one process per device). Default: every
    process on the 'data' axis, the other axes 1. A shape whose devices
    are not the world's raises ValueError."""
    n = world_size()
    axes = tuple(axes)
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) > len(axes):
        raise ValueError(f"mesh shape {shape} has more axes than {axes}")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices (one process a device: the mesh is the world)")
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(axes[: len(shape)], shape, group, dist.get_rank() if dist.is_initialized() else 0)
