"""Model registry: config -> model (port of alignq_tpu/models/registry.py,
the two PreAct ResNets)."""

from __future__ import annotations

from typing import Optional

import torch

from alignq_tpu_torch.models.resnet_cifar import PreActResNet, resnet20_quant, resnet56_quant
from alignq_tpu_torch.train.config import TrainConfig

BUILDERS = {"resnet20_quant": resnet20_quant, "resnet56_quant": resnet56_quant}


def build_model(cfg: TrainConfig, generator: Optional[torch.Generator] = None) -> PreActResNet:
    """The config's model, its weights drawn from `generator` on the CPU.
    DenseNet-40 and MobileNet-V2 are ROADMAP queue 1 item 7."""
    if cfg.target_model not in BUILDERS:
        raise ValueError(f"unknown target_model {cfg.target_model!r}; the port has {sorted(BUILDERS)}")
    if cfg.stream_int8 and not cfg.deploy_exact:
        raise ValueError("stream_int8 requires deploy_exact")
    if cfg.stage_int8:
        raise ValueError("stage_int8 (int8 stage buffer) is a DenseNet deploy option")
    return BUILDERS[cfg.target_model](
        bitW=cfg.bitW, abitW=cfg.abitW, method=cfg.method, admm=cfg.admm, variant=cfg.variant,
        act_range=cfg.act_range, num_classes=cfg.num_classes, cdf_impl=cfg.cdf_impl,
        mxu_dtype=torch.bfloat16 if cfg.mxu_bf16 else None, deploy_exact=cfg.deploy_exact,
        stream_int8=cfg.stream_int8, generator=generator,
    )
