"""DenseNet-40 for CIFAR, quantized (port of alignq_tpu/models/densenet.py).

Pre-activation dense blocks (bn -> act_q -> relu -> conv3x3, concat on the
channel axis), 1x1 quantized transition convs with a 2x2 average pool,
growth rate 12, compression 1 for densenet_40_quant: stage buffers 168,
312 and 456 channels wide. Conv kernels are drawn He-normal over fan-out,
the reference's init (dense-cifar-10/model/densenet.py:113-116).

deploy_exact fake-quantizes the image stem input on the INT graph's S_IMG
grid, its only requant site. stage_int8 trains through the int8 stage
buffer's calibrated per-channel requant (nn/layers.py StageRequant) at the
stem output (`requant_stem`), every block's appended features and every
transition's pooled output (`requant`). The reference's dropout (rate 0 in
every configuration) is not ported.

The model takes NHWC images and runs NCHW inside. Submodules carry flax's
names (`conv1`, `dense{s}_{i}.{bn1, act_q0, conv1, requant}`,
`trans{s}.{bn1, act_q0, conv1, requant}`, `requant_stem`, `bn`, `act_q0`,
`fc`), so the ADMM sites and interop's weight map are the JAX package's.
The optimizer corrects every conv, the stem's included (configs.py:
correction_exclude=()).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from alignq_tpu_torch.nn.layers import BatchNorm, QConv, QDense, QuantAct, StageRequant
from alignq_tpu_torch.quant.ste import requant_ste

Sink = Optional[Dict[str, torch.Tensor]]


class _PreActConv(nn.Module):
    """bn1 -> act_q0 -> relu -> conv1, the body of a dense block and of a
    transition; `requant` (stage_int8) added by the owner."""

    def __init__(self, in_planes: int, out_planes: int, ksize: int, q: dict, generator):
        super().__init__()
        self.bn1 = BatchNorm(in_planes)
        self.act_q0 = QuantAct(a_bit=q["a_bit"], act_range=q["act_range"], method=q["method"], variant=q["variant"],
                               admm=q["admm"], cdf_impl=q["cdf_impl"], generator=generator)
        self.conv1 = QConv(in_planes, out_planes, ksize, 1, ksize // 2, w_bit=q["w_bit"], a_bit=q["a_bit"],
                           method=q["method"], variant=q["variant"], mxu_dtype=q["mxu_dtype"], init="he_fan_out",
                           generator=generator)

    def pre_act_conv(self, x: torch.Tensor, train: bool, sink: Sink) -> torch.Tensor:
        return self.conv1(torch.relu(self.act_q0(self.bn1(x, train), sink)))


class DenseBasicBlock(_PreActConv):
    def __init__(self, in_planes: int, growth_rate: int, q: dict, stage_int8: bool = False,
                 stage_calib: str = "max", generator: Optional[torch.Generator] = None):
        super().__init__(in_planes, growth_rate, 3, q, generator)
        if stage_int8:
            # the appended features live in the deployed graph's int8 stage buffer
            self.requant = StageRequant(growth_rate, calib=stage_calib)

    def forward(self, x: torch.Tensor, train: bool = False, sink: Sink = None) -> torch.Tensor:
        out = self.pre_act_conv(x, train, sink)
        if hasattr(self, "requant"):
            out = self.requant(out, train)
        return torch.cat([x, out], dim=1)


class Transition(_PreActConv):
    def __init__(self, in_planes: int, out_planes: int, q: dict, stage_int8: bool = False,
                 stage_calib: str = "max", generator: Optional[torch.Generator] = None):
        super().__init__(in_planes, out_planes, 1, q, generator)
        if stage_int8:
            # the pooled output seeds the next stage's int8 buffer
            self.requant = StageRequant(out_planes, calib=stage_calib)

    def forward(self, x: torch.Tensor, train: bool = False, sink: Sink = None) -> torch.Tensor:
        out = F.avg_pool2d(self.pre_act_conv(x, train, sink), 2)
        if hasattr(self, "requant"):
            out = self.requant(out, train)
        return out


class DenseNet(nn.Module):
    """DenseNet of depth 3n+4: stem conv (2 * growth_rate), three stages of
    n dense blocks with a transition after the first two, bn -> act_q0 ->
    relu, mean pool, FP head `fc`. Kernels drawn from `generator` on the
    CPU (call .to(device) after)."""

    def __init__(self, depth: int = 40, growth_rate: int = 12, compression_rate: int = 1, num_classes: int = 10,
                 w_bit: int = 8, a_bit: int = 8, method: str = "ours", variant: str = "b", act_range: float = 2.0,
                 admm: bool = False, cdf_impl: str = "erf", mxu_dtype=None, deploy_exact: bool = False,
                 stage_int8: bool = False, stage_calib: str = "max", generator: Optional[torch.Generator] = None):
        super().__init__()
        if (depth - 4) % 3:
            raise ValueError(f"DenseNet depth must be 3n+4, got {depth}")
        self.depth, self.deploy_exact, self.stage_int8 = depth, deploy_exact, stage_int8
        q = dict(w_bit=w_bit, a_bit=a_bit, method=method, variant=variant, act_range=act_range, admm=admm,
                 cdf_impl=cdf_impl, mxu_dtype=mxu_dtype)
        st = dict(stage_int8=stage_int8, stage_calib=stage_calib, generator=generator)
        n = (depth - 4) // 3
        planes = 2 * growth_rate
        self.conv1 = QConv(3, planes, 3, 1, 1, w_bit=w_bit, a_bit=a_bit, method=method, variant=variant,
                           mxu_dtype=mxu_dtype,
                           init="he_fan_out", generator=generator)
        if stage_int8:
            self.requant_stem = StageRequant(planes, calib=stage_calib)
        self.stages = []
        for stage in range(3):
            names = []
            for i in range(n):
                names.append(f"dense{stage + 1}_{i}")
                self.add_module(names[-1], DenseBasicBlock(planes, growth_rate, q, **st))
                planes += growth_rate
            if stage < 2:
                names.append(f"trans{stage + 1}")
                self.add_module(names[-1], Transition(planes, planes // compression_rate, q, **st))
                planes //= compression_rate
            self.stages.append(names)
        self.bn = BatchNorm(planes)
        self.act_q0 = QuantAct(a_bit=a_bit, act_range=act_range, method=method, variant=variant, admm=admm,
                               cdf_impl=cdf_impl, generator=generator)
        self.fc = QDense(planes, num_classes, generator=generator)
        for name, m in self.named_modules():
            if isinstance(m, QuantAct):
                m.site = name.replace(".", "/") + "/d"

    def forward(self, x: torch.Tensor, train: bool = False, sink: Sink = None) -> torch.Tensor:
        """NHWC images -> logits; sink as PreActResNet's."""
        if self.deploy_exact:
            x = requant_ste(x, 3.0 / 127.0, 127)  # the INT graph's S_IMG stem input
        out = self.conv1(x.permute(0, 3, 1, 2).contiguous())
        if self.stage_int8:
            out = self.requant_stem(out, train)
        for names in self.stages:
            for name in names:
                out = getattr(self, name)(out, train, sink)
        out = torch.relu(self.act_q0(self.bn(out, train), sink))
        return self.fc(out.mean(dim=(2, 3)))


def densenet_40_quant(bitW: int = 8, abitW: int = 8, method: str = "ours", admm: bool = False, **kw) -> DenseNet:
    """The reference's densenet_40_quant (densenet.py:158-159): depth 40,
    compression 1."""
    return DenseNet(depth=40, compression_rate=1, w_bit=bitW, a_bit=abitW, method=method, admm=admm, **kw)
