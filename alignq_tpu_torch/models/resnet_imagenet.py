"""Quantized torchvision-layout ResNet-18/34/50 feature extractors (port of
alignq_tpu/models/resnet_imagenet.py).

NCHW modules with flax's names: the stem `conv1` (7x7 stride 2, pad 3),
`bn1`, `act_q0`, then `layer{s}_{b}` blocks of `conv1`, `bn1`, `act_q1`,
`conv2`, `bn2`, `act_q2` (and `conv3`, `bn3`, `act_q3` in a Bottleneck),
`downsample_conv` and `downsample_bn` where the block changes shape. The
model takes NHWC images, as the JAX model does, and returns the pooled
penultimate feature (no head).

- Every block is conv -> bn -> act_q -> relu, but for its last act site,
  which has no relu before the residual add. ADMM sites sit on that last
  site only (`act_q2` of a BasicBlock, `act_q3` of a Bottleneck). The
  downsample path has no act site.
- stage 'align' (with method 'ours'): at 32-bit activations every site
  still applies the CDF transform (nn/layers.py QuantAct).
- The 3x3 stride-2 max pool after the stem pads with -inf. Its gradient
  goes to the first maximum of each window in row-major order, as XLA's
  select_and_scatter gives it, scattered over overlapping windows
  (tests/test_torch_resnet_imagenet.py holds this on tied inputs).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from alignq_tpu_torch.nn.layers import BatchNorm, QConv, QuantAct

Sink = Optional[Dict[str, torch.Tensor]]


def _makers(w_bit: int, a_bit: int, method: str, variant: str, act_range: float, stage: str, cdf_impl: str,
            generator: Optional[torch.Generator], **_):
    """A block's conv and act-site constructors, from the trunk's quantizer
    options (the JAX blocks' `kw` and `act_kw`)."""

    def conv(cin, cout, k, s):
        return QConv(cin, cout, k, s, k // 2, w_bit=w_bit, a_bit=a_bit, method=method, variant=variant,
                     generator=generator)

    def act(admm=False):
        return QuantAct(a_bit=a_bit, act_range=act_range, method=method, variant=variant, admm=admm,
                        cdf_impl=cdf_impl, stage=stage, generator=generator)

    return conv, act


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1, has_downsample: bool = False, **q):
        super().__init__()
        conv, act = _makers(**q)
        self.conv1 = conv(in_planes, planes, 3, stride)
        self.bn1 = BatchNorm(planes)
        self.act_q1 = act()
        self.conv2 = conv(planes, planes, 3, 1)
        self.bn2 = BatchNorm(planes)
        self.act_q2 = act(q["admm"])  # the block's ADMM site
        if has_downsample:
            self.downsample_conv = conv(in_planes, planes, 1, stride)
            self.downsample_bn = BatchNorm(planes)

    def forward(self, x: torch.Tensor, train: bool = False, sink: Sink = None) -> torch.Tensor:
        out = torch.relu(self.act_q1(self.bn1(self.conv1(x), train)))
        out = self.act_q2(self.bn2(self.conv2(out), train), sink)
        return torch.relu(out + _identity(self, x, train))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1, has_downsample: bool = False, **q):
        super().__init__()
        conv, act = _makers(**q)
        self.conv1 = conv(in_planes, planes, 1, 1)
        self.bn1 = BatchNorm(planes)
        self.act_q1 = act()
        self.conv2 = conv(planes, planes, 3, stride)  # the stride sits on the 3x3
        self.bn2 = BatchNorm(planes)
        self.act_q2 = act()
        self.conv3 = conv(planes, planes * 4, 1, 1)
        self.bn3 = BatchNorm(planes * 4)
        self.act_q3 = act(q["admm"])  # the block's ADMM site
        if has_downsample:
            self.downsample_conv = conv(in_planes, planes * 4, 1, stride)
            self.downsample_bn = BatchNorm(planes * 4)

    def forward(self, x: torch.Tensor, train: bool = False, sink: Sink = None) -> torch.Tensor:
        out = torch.relu(self.act_q1(self.bn1(self.conv1(x), train)))
        out = torch.relu(self.act_q2(self.bn2(self.conv2(out), train)))
        out = self.act_q3(self.bn3(self.conv3(out), train), sink)
        return torch.relu(out + _identity(self, x, train))


def _identity(block: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
    """The block's shortcut: its downsample conv and BN, no act site."""
    if hasattr(block, "downsample_conv"):
        return block.downsample_bn(block.downsample_conv(x), train)
    return x


class ResNetFeature(nn.Module):
    """ImageNet-layout ResNet trunk: NHWC images -> the pooled feature
    (B, 512 * expansion). The kernels are drawn from `generator` on the CPU
    (torch's conv init, as the JAX package's QConv), then .to(device)."""

    def __init__(self, block: type = Bottleneck, layers: Sequence[int] = (3, 4, 6, 3), w_bit: int = 8,
                 a_bit: int = 8, method: str = "ours", variant: str = "b", act_range: float = 2.0,
                 admm: bool = False, stage: str = "quant", cdf_impl: str = "erf",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        q = dict(w_bit=w_bit, a_bit=a_bit, method=method, variant=variant, act_range=act_range, admm=admm,
                 stage=stage, cdf_impl=cdf_impl, generator=generator)
        self.conv1 = QConv(3, 64, 7, 2, 3, w_bit=w_bit, a_bit=a_bit, method=method, variant=variant,
                           generator=generator)
        self.bn1 = BatchNorm(64)
        self.act_q0 = QuantAct(a_bit=a_bit, act_range=act_range, method=method, variant=variant, stage=stage,
                               cdf_impl=cdf_impl, generator=generator)
        self.block_names = []
        inplanes = 64
        for s, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            for b in range(blocks):
                stride = (1 if s == 0 else 2) if b == 0 else 1
                has_ds = b == 0 and (stride != 1 or inplanes != planes * block.expansion)
                name = f"layer{s + 1}_{b}"
                self.add_module(name, block(inplanes, planes, stride, has_ds, **q))
                self.block_names.append(name)
                inplanes = planes * block.expansion
        self.features = inplanes
        for name, m in self.named_modules():
            if isinstance(m, QuantAct):
                m.site = name.replace(".", "/") + "/d"

    def forward(self, x: torch.Tensor, train: bool = False, sink: Sink = None) -> torch.Tensor:
        out = self.bn1(self.conv1(x.permute(0, 3, 1, 2).contiguous()), train)
        out = torch.relu(self.act_q0(out))
        out = F.max_pool2d(out, 3, 2, 1)  # pads with -inf
        for name in self.block_names:
            out = getattr(self, name)(out, train, sink)
        return out.mean(dim=(2, 3))


def resnet18_quant(bitW: int = 8, abitW: int = 8, method: str = "ours", admm: bool = False, **kw) -> ResNetFeature:
    return ResNetFeature(block=BasicBlock, layers=(2, 2, 2, 2), w_bit=bitW, a_bit=abitW, method=method, admm=admm,
                         **kw)


def resnet34_quant(bitW: int = 8, abitW: int = 8, method: str = "ours", admm: bool = False, **kw) -> ResNetFeature:
    return ResNetFeature(block=BasicBlock, layers=(3, 4, 6, 3), w_bit=bitW, a_bit=abitW, method=method, admm=admm,
                         **kw)


def resnet50_quant(bitW: int = 8, abitW: int = 8, method: str = "ours", admm: bool = False, **kw) -> ResNetFeature:
    return ResNetFeature(block=Bottleneck, layers=(3, 4, 6, 3), w_bit=bitW, a_bit=abitW, method=method, admm=admm,
                         **kw)
