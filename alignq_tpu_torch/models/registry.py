"""Model registry: config -> model (port of alignq_tpu/models/registry.py:
the PreAct ResNets, DenseNet-40 and MobileNet-V2)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from alignq_tpu_torch.models.densenet import densenet_40_quant
from alignq_tpu_torch.models.mobilenetv2 import mobile_v2
from alignq_tpu_torch.models.resnet_cifar import resnet20_quant, resnet56_quant
from alignq_tpu_torch.train.config import TrainConfig

BUILDERS = {"resnet20_quant": resnet20_quant, "resnet56_quant": resnet56_quant,
            "densenet_40_quant": densenet_40_quant, "mobile_v2": mobile_v2}
PREACT = ("resnet20_quant", "resnet56_quant")


def build_model(cfg: TrainConfig, generator: Optional[torch.Generator] = None) -> nn.Module:
    """The config's model, its weights drawn from `generator` on the CPU.
    deploy_exact serves every family; stream_int8 (the int8 residual
    stream) is the PreAct ResNets' and stage_int8 (the int8 stage buffer)
    DenseNet's, each only with deploy_exact."""
    name = cfg.target_model
    if name not in BUILDERS:
        raise ValueError(f"unknown target_model {name!r}; the port has {sorted(BUILDERS)}")
    kw = dict(bitW=cfg.bitW, abitW=cfg.abitW, method=cfg.method, admm=cfg.admm, variant=cfg.variant,
              act_range=cfg.act_range, num_classes=cfg.num_classes, cdf_impl=cfg.cdf_impl,
              mxu_dtype=torch.bfloat16 if cfg.mxu_bf16 else None, deploy_exact=cfg.deploy_exact,
              generator=generator)
    if cfg.stream_int8:
        if not cfg.deploy_exact:
            raise ValueError("stream_int8 requires deploy_exact")
        if name not in PREACT:
            raise ValueError("stream_int8 (int8 residual stream) is a PreActResNet deploy option")
        kw["stream_int8"] = True
    if cfg.stage_int8:
        if name != "densenet_40_quant":
            raise ValueError("stage_int8 (int8 stage buffer) is a DenseNet deploy option")
        if not cfg.deploy_exact:
            # the int8-buffer graph also requantizes the image stem input
            raise ValueError("stage_int8 requires deploy_exact")
        kw.update(stage_int8=True, stage_calib=cfg.stage_calib)
    return BUILDERS[name](**kw)
