"""Train and eval steps (port of alignq_tpu/train/steps.py).

One train step: a forward that collects every ADMM site's D, one backward
of CE + the sum of the sites' trans losses, the BatchNorm statistics (set
by the forward), the AlignQ SGD update, then each site's closed-form dual
update. It runs eagerly: a step is a chain of PyTorch calls.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from alignq_tpu_torch.admm.loss import ADMMConfig, admm_loss
from alignq_tpu_torch.admm.state import dual_update
from alignq_tpu_torch.train.config import TrainConfig
from alignq_tpu_torch.train.state import TrainState


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels.long())


def _no_axis(axis_name: Optional[str]) -> None:
    if axis_name is not None:
        raise NotImplementedError("data-parallel steps wait for ROADMAP queue 1, Distribution")


def make_train_step(model: nn.Module, cfg: TrainConfig, axis_name: Optional[str] = None) -> Callable:
    """train_step(state, images, labels) -> (state, metrics), for a state
    that holds `model`; metrics are 0-dim tensors (loss, ce, trans,
    accuracy)."""
    _no_axis(axis_name)
    admm_cfg = ADMMConfig(mu=cfg.admm_mu, rho=cfg.admm_rho)
    use_admm = cfg.admm

    def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        if state.model is not model:
            raise ValueError("the state holds another model than this step trains")
        sink: Optional[Dict[str, torch.Tensor]] = {} if use_admm else None
        logits = model(images, train=True, sink=sink)
        ce = cross_entropy_loss(logits, labels)
        trans = 0.0
        if use_admm:
            for name in sorted(sink):
                site = state.admm_duals[name]
                trans = trans + admm_loss(sink[name], site.alter_d, site.gamma, admm_cfg)
        loss = ce + trans
        params = state.params
        grads = torch.autograd.grad(loss, list(params.values()))
        state.tx.step(params, dict(zip(params, grads)))
        if use_admm:
            for name, d in sink.items():
                state.admm_duals[name] = dual_update(state.admm_duals[name], d, admm_cfg)
        state.step += 1
        with torch.no_grad():
            acc = (logits.argmax(-1) == labels).float().mean()
            metrics = {"loss": loss.detach(), "ce": ce.detach(), "trans": (loss - ce).detach(), "accuracy": acc}
        return state, metrics

    return train_step


def make_eval_step(model: nn.Module, cfg: TrainConfig, axis_name: Optional[str] = None) -> Callable:
    """Pure eval: no statistics update, no trans loss. `model` may be a
    twin of the state's model (the f32 eval twin of a bf16 train model):
    it then runs on the state's parameters and statistics."""
    _no_axis(axis_name)

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
