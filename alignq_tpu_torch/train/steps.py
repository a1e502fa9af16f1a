"""Train and eval steps (port of alignq_tpu/train/steps.py).

One train step: a forward that collects every ADMM site's D, one backward
of CE + the sum of the sites' trans losses, the BatchNorm statistics (set
by the forward), the AlignQ SGD update, then each site's closed-form dual
update. It runs eagerly: a step is a chain of PyTorch calls.

Over a data-parallel mesh (one process per device, each step on this
rank's rows):
- corr_mode 'gather' equals the 1-process step over the global batch: the
  forward runs under the mesh's batch axis, so BatchNorm's statistics,
  StageRequant's max, each ADMM site's D (over gathered rows) and the
  baselines' batch terms are global (dist/collectives.py), and the
  gradients' f32 mean follows (JAX's GSPMD step reduces in f32 whatever
  cfg.grad_compression says);
- corr_mode 'local' keeps every one of them per shard, as JAX's shard_map
  step does, then takes the compressed gradient mean
  (cfg.grad_compression) and combines the statistics: MAX for every
  `amax`, the mean otherwise. The classification models have no dropout,
  so no stream is folded with the rank.
Either way the metrics are averaged over the ranks.

Over a ('data', 'model') mesh (gather mode only, as JAX's) the model's
column-parallel layers hold their slices (dist/sharding.py shard_model)
and gather their outputs: the step above runs unchanged on every rank,
its data-axis reductions over the data group (the ranks of one model
coordinate), and the gradients of the replicated tensors are then taken
from the first model rank (align_replicated_grads).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from alignq_tpu_torch.admm.loss import ADMMConfig, admm_loss
from alignq_tpu_torch.admm.state import dual_update
from alignq_tpu_torch.dist.collectives import batch_axis, compressed_tree_pmean, mean_over
from alignq_tpu_torch.dist.mesh import Mesh
from alignq_tpu_torch.train.config import TrainConfig
from alignq_tpu_torch.train.state import TrainState


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels.long())


def check_mesh(n_model: int, corr_mode: str) -> None:
    """JAX's refusals of a mesh the steps cannot take: an unknown corr
    mode, and 'local' with a 'model' axis (of n_model devices)."""
    if corr_mode not in ("gather", "local"):
        raise ValueError(f"unknown corr_mode {corr_mode!r}")
    if n_model > 1 and corr_mode != "gather":
        raise ValueError("tensor-parallel training (model axis > 1) requires corr_mode='gather'; 'local' shards "
                         "corr duals over the data axis only")


@torch.no_grad()
def align_replicated_grads(grads: Dict[str, torch.Tensor], shards, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The gradients of the tensors replicated over the model axis (every
    one but the column-parallel slices in `shards`) set to the first model
    rank's, one broadcast a dtype within the model group. Each model rank
    computed them itself; on the card the conv algorithms' run-to-run
    order could otherwise make the copies drift apart over steps."""
    axis = mesh.model_axis()
    if axis is None:
        return grads
    names = [k for k in grads if k not in shards]
    by_dtype: Dict[torch.dtype, list] = {}
    for k in names:
        by_dtype.setdefault(grads[k].dtype, []).append(k)
    out = dict(grads)
    for keys in by_dtype.values():
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        dist.broadcast(flat, src=dist.get_global_rank(axis.group, 0), group=axis.group)
        for k, part in zip(keys, torch.split(flat, [grads[k].numel() for k in keys])):
            out[k] = part.reshape(grads[k].shape)
    return out


@torch.no_grad()
def combine_batch_stats(model: nn.Module, group) -> None:
    """Every rank's statistics combined in place: StageRequant's `amax` by
    MAX (a mean of per-shard maxima understates the batch's max, and the
    EMA update is affine in it, so MAX is exact for 'max' and 'ema'), the
    BatchNorm statistics by their mean. One all-reduce each."""
    bufs = dict(model.named_buffers())
    for is_amax in (True, False):
        names = [n for n in bufs if (n.split(".")[-1] == "amax") == is_amax]
        if not names:
            continue
        flat = torch.cat([bufs[n].reshape(-1) for n in names])
        dist.all_reduce(flat, op=dist.ReduceOp.MAX if is_amax else dist.ReduceOp.SUM, group=group)
        if not is_amax:
            flat = flat * (1.0 / dist.get_world_size(group))
        for n, part in zip(names, torch.split(flat, [bufs[n].numel() for n in names])):
            bufs[n].copy_(part.reshape(bufs[n].shape))


def mean_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each metric's mean over the ranks (one all-reduce)."""
    names = list(metrics)
    vec = mean_over(torch.stack([metrics[k].to(metrics[names[0]].dtype) for k in names]), group)
    return dict(zip(names, vec.unbind()))


def make_train_step(model: nn.Module, cfg: TrainConfig, mesh: Optional[Mesh] = None) -> Callable:
    """train_step(state, images, labels) -> (state, metrics), for a state
    that holds `model`; metrics are 0-dim tensors (loss, ce, trans,
    accuracy). mesh: a data-parallel mesh (images and labels this rank's
    rows), run in cfg.corr_mode, with a model axis where `model` was
    placed on it (dist/sharding.py shard_model, and the optimizer's
    `shards`); None or one device: the plain step."""
    check_mesh(mesh.n_model if mesh is not None else 1, cfg.corr_mode)
    admm_cfg = ADMMConfig(mu=cfg.admm_mu, rho=cfg.admm_rho)
    use_admm = cfg.admm
    axis = mesh.batch_axis() if mesh is not None else None
    gather = axis is not None and cfg.corr_mode == "gather"

    def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        if state.model is not model:
            raise ValueError("the state holds another model than this step trains")
        sink: Optional[Dict[str, torch.Tensor]] = {} if use_admm else None
        with batch_axis(axis if gather else None):
            logits = model(images, train=True, sink=sink)
        ce = cross_entropy_loss(logits, labels)
        trans = 0.0
        if use_admm:
            for name in sorted(sink):
                site = state.admm_duals[name]
                trans = trans + admm_loss(sink[name], site.alter_d, site.gamma, admm_cfg)
        loss = ce + trans
        params = state.params
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if axis is not None:
            grads = compressed_tree_pmean(grads, axis.group, "f32" if gather else cfg.grad_compression)
            if not gather:
                combine_batch_stats(model, axis.group)
        if mesh is not None:
            grads = align_replicated_grads(grads, state.tx.shards, mesh)
        state.tx.step(params, grads)
        if use_admm:
            for name, d in sink.items():
                state.admm_duals[name] = dual_update(state.admm_duals[name], d, admm_cfg)
        state.step += 1
        with torch.no_grad():
            acc = (logits.argmax(-1) == labels).float().mean()
            metrics = {"loss": loss.detach(), "ce": ce.detach(), "trans": (loss - ce).detach(), "accuracy": acc}
        if axis is not None:
            metrics = mean_metrics(metrics, axis.group)
        return state, metrics

    return train_step


def make_eval_step(model: nn.Module, cfg: TrainConfig) -> Callable:
    """Pure eval: no statistics update, no trans loss. `model` may be a
    twin of the state's model (the f32 eval twin of a bf16 train model):
    it then runs on the state's parameters and statistics. An eval
    forward couples no rows, so under a mesh each rank evaluates its own
    and the loop reduces the meters (train/loop.py evaluate)."""

    @torch.no_grad()
    def eval_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        if state.model is model:
            logits = model(images, train=False)
        else:
            tensors = {**dict(state.model.named_parameters()), **dict(state.model.named_buffers())}
            logits = torch.func.functional_call(model, tensors, (images,), {"train": False})
        labels = labels.long()
        top5 = torch.topk(logits, min(5, logits.shape[-1]), dim=-1).indices
        return {
            "loss": cross_entropy_loss(logits, labels),
            "top1": (logits.argmax(-1) == labels).float().mean(),
            "top5": (top5 == labels[:, None]).any(-1).float().mean(),
        }

    return eval_step
