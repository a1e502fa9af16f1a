"""The device mesh (port of alignq_tpu/dist/mesh.py).

The JAX package runs one process over N devices and lays them out as a
('data', 'model') mesh. The port runs one process per device, the PyTorch
way, over the world of the default `torch.distributed` process group,
laid out row-major as JAX's `np.asarray(devices).reshape(shape)`: the
process of global rank r sits at data coordinate r // n_model and model
coordinate r % n_model. The data group holds the ranks of one model
coordinate (a batch is split over it); the model group the ranks of one
data coordinate (a tensor's channels are split over it). A mesh of one
device needs no process group.
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
    the process group of this rank's data axis (None for one device);
    rank: this process's coordinate on the data axis; model_group and
    model_rank: those of its model axis (None and 0 without one)."""

    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    group: Optional[Any]
    rank: int
    model_group: Optional[Any] = None
    model_rank: int = 0

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

    @property
    def data_rank(self) -> int:
        """This rank's coordinate on the data axis (`rank`)."""
        return self.rank

    def batch_axis(self) -> Optional[BatchAxis]:
        """The data axis the batch is split over; None without a process
        group, and for a data axis of one beside a model axis (a world of
        one process still reduces through its group)."""
        if self.group is None or (self.n_data == 1 and self.model_group is not None):
            return None
        return BatchAxis(self.group, self.rank, self.n_data)

    def model_axis(self) -> Optional[BatchAxis]:
        """The model axis a tensor's channels are split over; None without
        one larger than 1."""
        return BatchAxis(self.model_group, self.model_rank, self.n_model) if self.model_group is not None else None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Optional[Sequence[int]] = None, axes: Sequence[str] = ("data", "model")) -> Mesh:
    """A mesh over the world (one process per device), row-major. Default:
    every process on the 'data' axis, the other axes 1. A shape whose
    devices are not the world's raises ValueError. Every rank creates
    every data group, then every model group, in the same order (as
    torch.distributed.new_group requires); with a model axis of 1 the data
    group is the world."""
    n = world_size()
    axes = tuple(axes)
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) > len(axes):
        raise ValueError(f"mesh shape {shape} has more axes than {axes}")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices (one process a device: the mesh is the world)")
    axes = axes[: len(shape)]
    if not dist.is_initialized():
        return Mesh(axes, shape, None, 0)
    rank = dist.get_rank()
    n_data = shape[0]
    n_model = dict(zip(axes, shape)).get("model", 1)
    if n_model == 1:
        return Mesh(axes, shape, dist.group.WORLD, rank)
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)]) for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)]) for d in range(n_data)]
    d, m = divmod(rank, n_model)
    return Mesh(axes, shape, data_groups[m], d, model_groups[d], m)
