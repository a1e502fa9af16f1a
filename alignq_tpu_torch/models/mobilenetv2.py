"""MobileNet-V2 for SVHN and CIFAR, quantized (port of
alignq_tpu/models/mobilenetv2.py).

The reference's quirks stay (mobilenet-v2-svhn/model/mobilenetV2.py):
- conv2 of a block is depthwise (groups = planes);
- stride-1 blocks carry a quantized 1x1 shortcut conv even where identity
  would do, then bn -> act_skip -> relu;
- ReLU6 after act_q1 and act_q2, no relu after act_q3; the head takes a
  plain relu;
- the stem has stride 1 (32x32 inputs), the head a mean pool.

deploy_exact fake-quantizes the INT graph's requant sites: the stem input
on the S_IMG grid, and the input of each block that follows a stride-1
block (and of the head conv when the last block is one) on the signed
m = 2 block-input grid (quant/ste.py requant_grid_ste, signed: a3 has no
relu, so the stream carries negative codes).

The model takes NHWC images and runs NCHW inside; submodules carry flax's
names (`conv1`, `bn1`, `act_q1`, `layers_{i}.{conv1..3, bn1..3,
act_q1..3, shortcut_conv, shortcut_bn, act_skip}`, `conv2`, `bn2`,
`act_q2`, `linear`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from alignq_tpu_torch.kernels.infer_mobilenet import CFG  # (expansion, out_planes, num_blocks, stride)
from alignq_tpu_torch.nn.layers import BatchNorm, QConv, QDense, QuantAct
from alignq_tpu_torch.quant.ste import requant_grid_ste, requant_ste

Sink = Optional[Dict[str, torch.Tensor]]


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.relu(x), x.new_tensor(6.0))


class InvertedResidual(nn.Module):
    """1x1 expand -> 3x3 depthwise (stride) -> 1x1 project, each conv ->
    bn -> act site; requant_m: the signed block-input requant of
    deploy_exact, None where the block follows the stem or a stride-2
    block (there the INT graph's m = 1 requant is a clamp that QAT values
    never reach)."""

    def __init__(self, in_planes: int, out_planes: int, expansion: int, stride: int, q: dict,
                 requant_m: Optional[int] = None, requant_g: int = 127, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.act_range, self.requant_m, self.requant_g = stride, q["act_range"], requant_m, requant_g
        planes = expansion * in_planes

        def conv(cin, cout, k, s=1, groups=1):
            return QConv(cin, cout, k, s, k // 2, w_bit=q["w_bit"], a_bit=q["a_bit"], method=q["method"],
                         variant=q["variant"],
                         mxu_dtype=q["mxu_dtype"], groups=groups, generator=generator)

        def act():
            return QuantAct(a_bit=q["a_bit"], act_range=q["act_range"], method=q["method"], variant=q["variant"],
                            admm=q["admm"], cdf_impl=q["cdf_impl"], generator=generator)

        self.conv1, self.bn1, self.act_q1 = conv(in_planes, planes, 1), BatchNorm(planes), act()
        self.conv2, self.bn2, self.act_q2 = conv(planes, planes, 3, stride, planes), BatchNorm(planes), act()
        self.conv3, self.bn3, self.act_q3 = conv(planes, out_planes, 1), BatchNorm(out_planes), act()
        if stride == 1:
            self.shortcut_conv, self.shortcut_bn = conv(in_planes, out_planes, 1), BatchNorm(out_planes)
            self.act_skip = act()

    def forward(self, x: torch.Tensor, train: bool = False, sink: Sink = None) -> torch.Tensor:
        if self.requant_m is not None:
            x = requant_grid_ste(x, self.act_range / self.requant_g, self.requant_m, self.requant_g, True)
        out = _relu6(self.act_q1(self.bn1(self.conv1(x), train), sink))
        out = _relu6(self.act_q2(self.bn2(self.conv2(out), train), sink))
        out = self.act_q3(self.bn3(self.conv3(out), train), sink)
        if self.stride == 1:
            sc = self.act_skip(self.shortcut_bn(self.shortcut_conv(x), train), sink)
            out = out + torch.relu(sc)
        return out


class MobileNetV2(nn.Module):
    """Stem conv (32, stride 1), the 17 blocks of CFG, the 1280-wide head
    conv, mean pool, FP head `linear`. Kernels drawn from `generator` on
    the CPU (call .to(device) after)."""

    def __init__(self, num_classes: int = 10, w_bit: int = 8, a_bit: int = 8, method: str = "ours",
                 variant: str = "b", act_range: float = 2.0, admm: bool = False, cdf_impl: str = "erf",
                 mxu_dtype=None, deploy_exact: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.deploy_exact, self.act_range = deploy_exact, act_range
        q = dict(w_bit=w_bit, a_bit=a_bit, method=method, variant=variant, act_range=act_range, admm=admm,
                 cdf_impl=cdf_impl, mxu_dtype=mxu_dtype)
        self.requant_g = 2 ** (a_bit - 1) - 1
        self.conv1 = QConv(3, 32, 3, 1, 1, w_bit=w_bit, a_bit=a_bit, method=method, variant=variant,
                           mxu_dtype=mxu_dtype,
                           generator=generator)
        self.bn1 = BatchNorm(32)
        self.act_q1 = QuantAct(a_bit=a_bit, act_range=act_range, method=method, variant=variant, admm=admm,
                               cdf_impl=cdf_impl, generator=generator)
        # the stream's grid multiplier entering each block: 1 after the stem
        # or a stride-2 block (bare act codes), 2 after a stride-1 block (the
        # residual sum a3 + relu(sc), codes in [-g, 2g])
        m_in, cin, self.num_blocks = 1, 32, 0
        for expansion, out_planes, num_blocks, stride in CFG:
            for s in [stride] + [1] * (num_blocks - 1):
                self.add_module(f"layers_{self.num_blocks}", InvertedResidual(
                    cin, out_planes, expansion, s, q, requant_m=m_in if deploy_exact and m_in > 1 else None,
                    requant_g=self.requant_g, generator=generator))
                m_in, cin, self.num_blocks = (2 if s == 1 else 1), out_planes, self.num_blocks + 1
        self.head_requant_m = m_in if deploy_exact and m_in > 1 else None
        self.conv2 = QConv(cin, 1280, 1, 1, 0, w_bit=w_bit, a_bit=a_bit, method=method, variant=variant,
                           mxu_dtype=mxu_dtype,
                           generator=generator)
        self.bn2 = BatchNorm(1280)
        self.act_q2 = QuantAct(a_bit=a_bit, act_range=act_range, method=method, variant=variant, admm=admm,
                               cdf_impl=cdf_impl, generator=generator)
        self.linear = QDense(1280, num_classes, generator=generator)
        for name, m in self.named_modules():
            if isinstance(m, QuantAct):
                m.site = name.replace(".", "/") + "/d"

    def forward(self, x: torch.Tensor, train: bool = False, sink: Sink = None) -> torch.Tensor:
        """NHWC images -> logits; sink as PreActResNet's."""
        if self.deploy_exact:
            x = requant_ste(x, 3.0 / 127.0, 127)  # the INT graph's S_IMG stem input
        out = torch.relu(self.act_q1(self.bn1(self.conv1(x.permute(0, 3, 1, 2).contiguous()), train), sink))
        for i in range(self.num_blocks):
            out = getattr(self, f"layers_{i}")(out, train, sink)
        if self.head_requant_m is not None:
            # the head conv takes the last residual block's output through
            # the same signed requant
            out = requant_grid_ste(out, self.act_range / self.requant_g, self.head_requant_m, self.requant_g, True)
        out = torch.relu(self.act_q2(self.bn2(self.conv2(out), train), sink))
        return self.linear(out.mean(dim=(2, 3)))


def mobile_v2(bitW: int = 8, abitW: int = 8, method: str = "ours", admm: bool = False, **kw) -> MobileNetV2:
    """The reference's mobile_v2 (mobilenetV2.py:134-135)."""
    return MobileNetV2(w_bit=bitW, a_bit=abitW, method=method, admm=admm, **kw)
