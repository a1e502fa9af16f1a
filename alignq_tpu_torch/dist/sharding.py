"""Placement of batches and state over a data-parallel mesh (port of
alignq_tpu/dist/sharding.py, its data-parallel half).

One process per device: a sharded batch is this rank's contiguous rows
(`shard_batch`), and replicated state is a full copy on every rank, made
equal by a broadcast from rank 0 (`replicated`). The tensor-parallel half
(`param_shardings`, `qparams_shardings`, `place_qparams`: conv kernels
split on their output channels over a 'model' axis) waits for ROADMAP
queue 1 item 3's tensor-parallel half.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist

from alignq_tpu_torch.dist.mesh import Mesh
from alignq_tpu_torch.dist.multihost import local_batch_slice


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of a global batch (arrays or tensors in tuples,
    lists or dicts) on the mesh's data axis."""
    return local_batch_slice(batch, mesh.n_data, mesh.rank)


@torch.no_grad()
def replicated(tensors: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Every rank's tensors set to rank 0's, in place (one broadcast a
    tensor); the identity on one device."""
    if mesh.group is not None and mesh.n_data > 1:
        for t in tensors.values():
            dist.broadcast(t, src=0, group=mesh.group)
    return tensors
