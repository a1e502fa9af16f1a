"""Train state: the model (parameters and BatchNorm statistics), the
optimizer, the ADMM duals and the step count (port of
alignq_tpu/train/state.py). The duals are updated by closed-form
assignment in the train step, not by an optimizer."""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict

import torch
from torch import nn

from alignq_tpu_torch.admm.state import ADMMSiteState, init_site
from alignq_tpu_torch.optim.correction import build_correction_mask
from alignq_tpu_torch.optim.factory import AlignQSGD, alignq_sgd
from alignq_tpu_torch.optim.schedules import multistep_schedule
from alignq_tpu_torch.train.config import TrainConfig


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: AlignQSGD
    admm_duals: Dict[str, ADMMSiteState]

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())


@torch.no_grad()
def admm_sites(model: nn.Module, batch_size: int, input_shape, **forward_kw) -> list:
    """The names of the model's ADMM sites, from one corr-collecting train
    forward at the train batch size (D is batch x batch) run on a copy of
    the model on the meta device: shapes only, and the model's BatchNorm
    statistics untouched. forward_kw: the forward's other arguments (a
    dropout's rng)."""
    dtype = next(model.parameters()).dtype
    meta = copy.deepcopy(model).to("meta")
    sink: Dict[str, torch.Tensor] = {}
    meta(torch.zeros((batch_size,) + tuple(input_shape[1:]), dtype=dtype, device="meta"), train=True, sink=sink,
         **forward_kw)
    return sorted(sink)


def create_train_state(generator: torch.Generator, model: nn.Module, cfg: TrainConfig, input_shape=(1, 32, 32, 3),
                       steps_per_epoch: int = 391) -> TrainState:
    """The optimizer and the ADMM duals (U[0, 1), drawn from `generator` on
    the CPU, one site after another in sorted order) for a model whose
    weights are already initialized and on their device."""
    p = next(model.parameters())
    admm_duals: Dict[str, ADMMSiteState] = {}
    if cfg.admm:
        for name in admm_sites(model, cfg.train_batch_size, input_shape):
            admm_duals[name] = init_site(generator, cfg.train_batch_size, p.dtype, p.device)
    schedule = multistep_schedule(cfg.lr, cfg.lr_decay_steps, cfg.lr_gamma, steps_per_epoch,
                                  warmup_epochs=cfg.warmup_epochs)
    mask = build_correction_mask(dict(model.named_parameters()), exclude=tuple(cfg.correction_exclude))
    tx = alignq_sgd(schedule, momentum=cfg.momentum, weight_decay=cfg.weight_decay, w_bit=cfg.bitW, lam=cfg.lam,
                    lam2=cfg.lam2, correction_mask=mask,
                    use_correction=(cfg.method == "ours" and cfg.use_correction), channel_axis=0)
    return TrainState(step=0, model=model, tx=tx, admm_duals=admm_duals)
