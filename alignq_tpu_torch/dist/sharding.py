"""Placement of batches, state and weights over a ('data', 'model') mesh
(port of alignq_tpu/dist/sharding.py).

One process per device. A sharded batch is this rank's contiguous rows
on the data axis (`shard_batch`). Replicated state is a full copy on
every rank, made equal by broadcasts from global rank 0 (`replicated`).

Tensor parallelism splits a tensor's output channels over the 'model'
axis, each rank holding its contiguous slice in rank order. JAX's rule,
in the port's layouts (`param_split_dim`, `param_shardings`):
- a conv `kernel` (the QAT layers' OIHW) splits on dim 0, its output
  channels, where they divide by the axis size;
- a dense `kernel` (in, out) splits on dim 1, on the same condition;
- everything else is replicated, and so is an indivisible kernel.
The frozen INT graph's qparams follow `qparams_shardings`: an int8 conv
kernel (HWIO) splits on its last dim where it divides; on a mesh without
a 'model' axis everything is replicated. The serving forward takes its
weights as K1's packed operands, and `shard_operands` gives each rank
the slice of every divisible one (kernels/qmatmul.py shard_k1weights),
whose K1 site gathers the channels back.

`shard_model` makes a QAT model column-parallel (nn/layers.py: each
sharded QConv and QDense holds its slice as the Parameter); `whole` and
`local_slice` move a parameter between its whole tensor and its slice.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from alignq_tpu_torch.dist.collectives import BatchAxis, gather_slices
from alignq_tpu_torch.dist.mesh import Mesh
from alignq_tpu_torch.dist.multihost import local_batch_slice, tree_map


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of a global batch (arrays or tensors in tuples,
    lists or dicts) on the mesh's data axis."""
    return local_batch_slice(batch, mesh.n_data, mesh.rank)


def _broadcast_from_first(t: torch.Tensor, axis: Optional[BatchAxis]) -> None:
    """t set to the first member's of the axis's group (a global src, as
    torch.distributed.broadcast takes even inside a subgroup)."""
    if axis is not None and axis.size > 1:
        dist.broadcast(t, src=dist.get_global_rank(axis.group, 0), group=axis.group)


@torch.no_grad()
def replicated(tensors: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Every rank's tensors set to global rank 0's, in place: a broadcast
    over the data axis from its first member, then over the model axis
    (one a tensor); the identity on one device."""
    for t in tensors.values():
        _broadcast_from_first(t, mesh.batch_axis())
        _broadcast_from_first(t, mesh.model_axis())
    return tensors


def param_split_dim(name: str, shape, n_model: int) -> Optional[int]:
    """The dimension a named QAT parameter splits on over a model axis of
    n_model, or None (replicated): JAX's param_shardings rule on the
    port's layouts."""
    if n_model <= 1 or name.split(".")[-1] != "kernel":
        return None
    if len(shape) == 4 and shape[0] % n_model == 0:
        return 0
    if len(shape) == 2 and shape[1] % n_model == 0:
        return 1
    return None


def param_shardings(params: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, Optional[int]]:
    """{name: the dimension it splits on, or None} over named parameters."""
    return {k: param_split_dim(k, tuple(v.shape), mesh.n_model) for k, v in params.items()}


def qparams_shardings(qparams: Any, mesh: Mesh) -> Any:
    """The qparams tree's structure with, at each leaf, the dimension it
    splits on (3: an HWIO int8 conv kernel whose output channels divide by
    the model axis) or None. A mesh without a 'model' axis replicates
    everything."""
    n = mesh.n_model

    def rule(leaf):
        if n > 1 and torch.is_tensor(leaf) and leaf.ndim == 4 and leaf.shape[-1] % n == 0:
            return 3
        return None

    return tree_map(rule, qparams)


def local_slice(t: torch.Tensor, dim: int, axis: BatchAxis) -> torch.Tensor:
    """This rank's contiguous slice of a whole tensor along `dim`."""
    w = t.shape[dim] // axis.size
    return t.narrow(dim, axis.rank * w, w).contiguous()


def place_qparams(qparams: Any, mesh: Mesh) -> Any:
    """The qparams with each leaf that qparams_shardings splits cut to this
    rank's slice."""
    axis = mesh.model_axis()
    if axis is None:
        return qparams

    def place(leaf):
        if torch.is_tensor(leaf) and leaf.ndim == 4 and leaf.shape[-1] % axis.size == 0:
            return local_slice(leaf, 3, axis)
        return leaf

    return tree_map(place, qparams)


def shard_operands(operands: Any, mesh: Optional[Mesh]) -> Any:
    """A serving forward's operand tree (a family's `operands`) with every
    K1Weights whose output channels divide by the model axis cut to this
    rank's slice, and each bins_int site's cutpoints with it; K3's, the
    depthwise form's and the BN-act operands stay whole. The identity
    without a model axis."""
    from alignq_tpu_torch.kernels.qmatmul import ActMap, K1Weights, shard_act_cutpoints, shard_k1weights

    axis = mesh.model_axis() if mesh is not None else None
    if axis is None:
        return operands

    def walk(tree):
        if isinstance(tree, K1Weights):
            return shard_k1weights(tree, axis)
        if isinstance(tree, ActMap):  # a bins_int site's cutpoints, cut as its conv is
            return shard_act_cutpoints(tree, axis)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    return walk(operands)


@dataclasses.dataclass(frozen=True)
class ParamShard:
    """A parameter's slice: the model axis and the dimension it splits."""

    axis: BatchAxis
    dim: int


def shard_model(model: torch.nn.Module, mesh: Mesh) -> Dict[str, ParamShard]:
    """Make a QAT model column-parallel over the mesh's model axis, in
    place: each QConv and QDense whose kernel param_split_dim splits keeps
    this rank's slice as its Parameter (the same Parameter object) and
    learns its axis (`shard`). A grouped conv splits only where its groups
    divide too. Returns {parameter name: ParamShard}."""
    from alignq_tpu_torch.nn.layers import QConv, QDense

    axis = mesh.model_axis()
    out: Dict[str, ParamShard] = {}
    if axis is None:
        return out
    for prefix, mod in model.named_modules():
        if not isinstance(mod, (QConv, QDense)):
            continue
        name = f"{prefix}.kernel" if prefix else "kernel"
        dim = param_split_dim(name, tuple(mod.kernel.shape), axis.size)
        if dim is None or (isinstance(mod, QConv) and mod.groups > 1 and mod.groups % axis.size):
            continue
        with torch.no_grad():
            mod.kernel.data = local_slice(mod.kernel.data, dim, axis)
        mod.shard = axis
        out[name] = ParamShard(axis, dim)
    return out


def param_shards(model: torch.nn.Module) -> Dict[str, ParamShard]:
    """{parameter name: ParamShard} of a model that shard_model placed."""
    from alignq_tpu_torch.nn.layers import QConv

    return {(f"{prefix}.kernel" if prefix else "kernel"): ParamShard(mod.shard, 0 if isinstance(mod, QConv) else 1)
            for prefix, mod in model.named_modules() if getattr(mod, "shard", None) is not None}


@torch.no_grad()
def whole(t: torch.Tensor, shard: Optional[ParamShard]) -> torch.Tensor:
    """The whole tensor from every model rank's slice (collective over the
    model axis); t itself where it is not split."""
    return t if shard is None else gather_slices(t.detach(), shard.axis, shard.dim)


@torch.no_grad()
def whole_model(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of a column-parallel model holding whole tensors and no
    shards (collective over the model axis: every model rank calls it);
    the model itself where nothing is split. What export_int8 folds."""
    shards = param_shards(model)
    if not shards:
        return model
    params = dict(model.named_parameters())
    placed = {m: m.shard for m in model.modules() if getattr(m, "shard", None) is not None}
    for m in placed:  # a process group does not deep-copy: the copy holds no shard
        m.shard = None
    try:
        out = copy.deepcopy(model)
    finally:
        for m, axis in placed.items():
            m.shard = axis
    for name, p in out.named_parameters():
        if name in shards:
            p.data = whole(params[name], shards[name])
    return out
