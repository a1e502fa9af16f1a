"""PreAct ResNet-20/56 for CIFAR, quantized, with the optional ADMM
correlation sites (port of alignq_tpu/models/resnet_cifar.py).

Each method takes the reference's topology for it (ORDERING): 'ours'
(conv -> bn -> act_q -> relu; methods 'ours' and 'uniform_admm'), 'after'
(conv -> bn -> relu -> act_q; 'uniform', 'dorefa', 'llsq', 'bwn',
'bwnf') and 'none' (no act sites: 'lsq' and 'apot' quantize the input
inside each conv; 'fp').

The model takes NHWC images, as the JAX model, the data loaders and the
INT graph do, and runs NCHW inside. Submodules carry flax's names (`conv0`,
`bn`, `act_q0`, `layers_i.{conv0, conv1, skip_conv, bn0, bn1, skip_bn,
act_q0, act_q1, act_skip_q}`, `logit`), so the ADMM sites
(`layers_0/act_q0/d`), the correction mask and interop's weight map are
the JAX package's one for one.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from alignq_tpu_torch.kernels.infer import residual_multipliers
from alignq_tpu_torch.nn.layers import BatchNorm, QConv, QDense, QuantAct
from alignq_tpu_torch.quant.ste import requant_grid_ste, requant_ste

# method -> topology family (the reference's arch dispatch)
ORDERING = {
    "ours": "ours",
    "uniform_admm": "ours",  # the ablation keeps the 'ours' topology
    "uniform": "after",
    "dorefa": "after",
    "llsq": "after",
    "bwn": "after",
    "bwnf": "after",
    "apot": "none",
    "lsq": "none",
    "fp": "none",
}


def _ordering(method: str) -> str:
    if method not in ORDERING:
        raise ValueError(f"unknown quant method {method!r}; have {sorted(ORDERING)}")
    return ORDERING[method]

Sink = Optional[Dict[str, torch.Tensor]]


class PreActBlock(nn.Module):
    """One PreAct block in its method's ordering. requant_m (deploy-exact
    QAT): fake-quantize the conv0/skip input on the INT graph's m *
    act_scale grid with its exact integer rounding; the identity shortcut
    stays unrequantized, as the INT graph adds the full-resolution residual
    codes."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1, w_bit: int = 8, a_bit: int = 8,
                 method: str = "ours", variant: str = "b", act_range: float = 2.0, admm: bool = False,
                 channelwise: bool = False, cdf_impl: str = "erf", corr_eps: float = 1e-5, mxu_dtype=None,
                 requant_m: Optional[int] = None, requant_g: int = 127,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.act_range, self.requant_m, self.requant_g = stride, act_range, requant_m, requant_g
        self.ordering = _ordering(method)

        def conv(cin, k, s, p):
            return QConv(cin, out_planes, k, s, p, w_bit=w_bit, a_bit=a_bit, method=method, variant=variant,
                         channelwise=channelwise, mxu_dtype=mxu_dtype, generator=generator)

        def act():
            return QuantAct(a_bit=a_bit, act_range=act_range, method=method, variant=variant, admm=admm,
                            cdf_impl=cdf_impl, corr_eps=corr_eps, generator=generator)

        self.conv0 = conv(in_planes, 3, stride, 1)
        self.bn0 = BatchNorm(out_planes)
        self.conv1 = conv(out_planes, 3, 1, 1)
        self.bn1 = BatchNorm(out_planes)
        if stride != 1:
            self.skip_conv = conv(in_planes, 1, stride, 0)
            self.skip_bn = BatchNorm(out_planes)
        if self.ordering != "none":
            self.act_q0 = act()
            self.act_q1 = act()
            if stride != 1:
                self.act_skip_q = act()

    def forward(self, x: torch.Tensor, train: bool = False, sink: Sink = None) -> torch.Tensor:
        xq = x
        if self.requant_m is not None:
            xq = requant_grid_ste(x, self.act_range / self.requant_g, self.requant_m, self.requant_g)
        if self.stride != 1:
            shortcut = self.skip_bn(self.skip_conv(xq), train)
            if self.ordering != "none":
                shortcut = self.act_skip_q(shortcut, sink)
        else:
            shortcut = x
        out = self.bn0(self.conv0(xq), train)
        if self.ordering == "ours":  # conv -> bn -> act_q -> relu
            out = torch.relu(self.act_q0(out, sink))
        elif self.ordering == "after":  # conv -> bn -> relu -> act_q
            out = self.act_q0(torch.relu(out))
        else:
            out = torch.relu(out)
        out = self.bn1(self.conv1(out), train)
        if self.ordering == "ours":
            return torch.relu(self.act_q1(out, sink) + shortcut)
        if self.ordering == "after":
            return self.act_q1(torch.relu(out + shortcut))
        return torch.relu(out + shortcut)


class PreActResNet(nn.Module):
    """PreActResNet: stem conv (16), three stages of num_units blocks
    (16/32/64 channels), mean pool, FP head.

    deploy_exact: fake-quantize the stem input (S_IMG grid) and each
    block's input (residual_multipliers) as the INT graph does; pair with
    variant 'int8'. stream_int8 (needs deploy_exact): requantize the whole
    inter-block stream, shortcut included, at each block edge, the
    semantics of the INT graph's stream='int8'. block_bits: per-block
    weight bits. The kernels are drawn from `generator` on the CPU (call
    .to(device) after)."""

    def __init__(self, num_units: Sequence[int] = (3, 3, 3), num_classes: int = 10, w_bit: int = 8,
                 a_bit: int = 8, method: str = "ours", variant: str = "b", act_range: float = 2.0,
                 admm: bool = False, channelwise: bool = False, cdf_impl: str = "erf", corr_eps: float = 1e-5,
                 block_bits: Optional[Sequence[int]] = None, mxu_dtype=None, deploy_exact: bool = False,
                 stream_int8: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        if stream_int8 and not deploy_exact:
            raise ValueError("stream_int8 models the INT graph's requantized stream: it needs deploy_exact")
        self.ordering = _ordering(method)
        self.act_range, self.deploy_exact, self.stream_int8 = act_range, deploy_exact, stream_int8
        strides = [1] * num_units[0] + [2] + [1] * (num_units[1] - 1) + [2] + [1] * (num_units[2] - 1)
        channels = [16] * num_units[0] + [32] * num_units[1] + [64] * num_units[2]
        self.requant_g = 2 ** (a_bit - 1) - 1 if deploy_exact else 127
        self.requant_ms = residual_multipliers([s != 1 for s in strides]) if deploy_exact else [None] * len(strides)
        self.conv0 = QConv(3, 16, 3, 1, 1, w_bit=w_bit, a_bit=a_bit, method=method, variant=variant,
                           channelwise=channelwise, mxu_dtype=mxu_dtype, generator=generator)
        self.bn = BatchNorm(16)
        if self.ordering == "ours":
            self.act_q0 = QuantAct(a_bit=a_bit, act_range=act_range, method=method, variant=variant, admm=admm,
                                   cdf_impl=cdf_impl, corr_eps=corr_eps, generator=generator)
        elif self.ordering == "after":  # the stem's act site takes no ADMM
            self.act_q0 = QuantAct(a_bit=a_bit, act_range=act_range, method=method, variant=variant,
                                   cdf_impl=cdf_impl, generator=generator)
        cin = 16
        self.num_blocks = len(strides)
        for i, (stride, channel) in enumerate(zip(strides, channels)):
            self.add_module(f"layers_{i}", PreActBlock(
                cin, channel, stride, w_bit=w_bit if block_bits is None else block_bits[i], a_bit=a_bit,
                method=method, variant=variant, act_range=act_range, admm=admm, channelwise=channelwise,
                cdf_impl=cdf_impl, corr_eps=corr_eps, mxu_dtype=mxu_dtype,
                # stream_int8: the edge requant below covers the conv input
                # and the shortcut; the block's own input requant is off
                requant_m=None if stream_int8 else self.requant_ms[i], requant_g=self.requant_g,
                generator=generator,
            ))
            cin = channel
        self.logit = QDense(64, num_classes, generator=generator)
        for name, m in self.named_modules():
            if isinstance(m, QuantAct):
                m.site = name.replace(".", "/") + "/d"

    def forward(self, x: torch.Tensor, train: bool = False, sink: Sink = None) -> torch.Tensor:
        """NHWC images -> logits. sink: a dict that receives every ADMM
        site's D (a corr-collecting forward; the JAX model's
        compute_corr=True)."""
        if self.deploy_exact:
            x = requant_ste(x, 3.0 / 127.0, 127)  # the INT graph's S_IMG stem input
        out = self.bn(self.conv0(x.permute(0, 3, 1, 2).contiguous()), train)
        if self.ordering == "ours":
            out = torch.relu(self.act_q0(out, sink))
        elif self.ordering == "after":
            out = self.act_q0(torch.relu(out))
        else:
            out = torch.relu(out)
        for i in range(self.num_blocks):
            out = getattr(self, f"layers_{i}")(out, train, sink)
            if self.stream_int8 and i + 1 < self.num_blocks:
                out = requant_grid_ste(out, self.act_range / self.requant_g, self.requant_ms[i + 1],
                                       self.requant_g)
        return self.logit(out.mean(dim=(2, 3)))


def resnet20_quant(bitW: int = 8, abitW: int = 8, method: str = "ours", admm: bool = False, **kw) -> PreActResNet:
    return PreActResNet(num_units=(3, 3, 3), w_bit=bitW, a_bit=abitW, method=method, admm=admm, **kw)


def resnet56_quant(bitW: int = 8, abitW: int = 8, method: str = "ours", admm: bool = False, **kw) -> PreActResNet:
    return PreActResNet(num_units=(9, 9, 9), w_bit=bitW, a_bit=abitW, method=method, admm=admm, **kw)
