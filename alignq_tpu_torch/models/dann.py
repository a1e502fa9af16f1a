"""Domain-adaptation models (port of alignq_tpu/models/dann.py): DANN (the
GRL and a domain head), DSAN (LMMD, computed in the train step), and the
digit DANN CNN.

Parameter and submodule names are flax's (`feature`, `class_classifier`,
`domain_classifier`; `feature_layers`, `bottle`, `cls_fc`; the digit net's
`conv1`, `conv1_bn`, `conv1_actq`, ..., `classifier/fc0`, `classifier/bn0`,
...), and every ADMM site takes its flax path (`feature/layer1_0/act_q2/d`,
`conv2_actq/d`), so that interop.load_flax_tree carries JAX's parameters
across and the duals keep JAX's names. Images are NHWC, as in the JAX
models; the convs run NCHW.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from alignq_tpu_torch.models import resnet_imagenet
from alignq_tpu_torch.nn.dropout import Dropout, Rng
from alignq_tpu_torch.nn.grl import gradient_reversal
from alignq_tpu_torch.nn.layers import BatchNorm, QConv, QDense, QuantAct

Sink = Optional[Dict[str, torch.Tensor]]
TRUNKS = {"resnet18": resnet_imagenet.resnet18_quant, "resnet34": resnet_imagenet.resnet34_quant,
          "resnet50": resnet_imagenet.resnet50_quant}


def name_sites(model: nn.Module) -> nn.Module:
    """Every act site's ADMM key as its flax path from the model's root."""
    for name, m in model.named_modules():
        if isinstance(m, QuantAct):
            m.site = name.replace(".", "/") + "/d"
    return model


def _trunk(arch: str, generator, **q) -> resnet_imagenet.ResNetFeature:
    if arch not in TRUNKS:
        raise ValueError(f"unknown trunk {arch!r}; have {sorted(TRUNKS)}")
    return TRUNKS[arch](generator=generator, **q)


class DANN(nn.Module):
    """Feature trunk, class head, and a domain head on the reversed
    feature: (class logits, domain logits)."""

    def __init__(self, arch: str = "resnet50", num_classes: int = 31, w_bit: int = 8, a_bit: int = 8,
                 method: str = "ours", variant: str = "b", act_range: float = 2.0, admm: bool = False,
                 stage: str = "quant", cdf_impl: str = "erf", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature = _trunk(arch, generator, bitW=w_bit, abitW=a_bit, method=method, admm=admm, variant=variant,
                              act_range=act_range, stage=stage, cdf_impl=cdf_impl)
        self.class_classifier = QDense(self.feature.features, num_classes, generator=generator)
        self.domain_classifier = QDense(self.feature.features, 2, generator=generator)
        name_sites(self)

    def forward(self, x: torch.Tensor, alpha=1.0, train: bool = False, sink: Sink = None, rng: Rng = None):
        feature = self.feature(x, train, sink)
        return self.class_classifier(feature), self.domain_classifier(gradient_reversal(feature, alpha))


class DSAN(nn.Module):
    """Feature trunk, the optional 256-wide `bottle`, and `cls_fc`. With a
    target: (source logits, source embedding, target logits, target
    embedding); without, the source logits. Both passes write one sink,
    the target's D last (as JAX's flattened sow keeps the last)."""

    def __init__(self, arch: str = "resnet50", num_classes: int = 31, bottle_neck: bool = True, w_bit: int = 8,
                 a_bit: int = 8, method: str = "ours", variant: str = "b", act_range: float = 2.0,
                 admm: bool = False, stage: str = "quant", cdf_impl: str = "erf",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bottle_neck = bottle_neck
        self.feature_layers = _trunk(arch, generator, bitW=w_bit, abitW=a_bit, method=method, admm=admm,
                                     variant=variant, act_range=act_range, stage=stage, cdf_impl=cdf_impl)
        width = self.feature_layers.features
        if bottle_neck:
            self.bottle = QDense(width, 256, generator=generator)
            width = 256
        self.cls_fc = QDense(width, num_classes, generator=generator)
        name_sites(self)

    def embed(self, x: torch.Tensor, train: bool = False, sink: Sink = None) -> torch.Tensor:
        f = self.feature_layers(x, train, sink)
        return self.bottle(f) if self.bottle_neck else f

    def forward(self, source: torch.Tensor, target: Optional[torch.Tensor] = None, train: bool = False,
                sink: Sink = None, rng: Rng = None):
        s_feat = self.embed(source, train, sink)
        s_pred = self.cls_fc(s_feat)
        if target is None:
            return s_pred
        t_feat = self.embed(target, train, sink)
        return s_pred, s_feat, self.cls_fc(t_feat), t_feat


class GRLMlp(nn.Module):
    """QDense -> BatchNorm -> relu for each width but the last, then a
    QDense (the digit heads)."""

    def __init__(self, in_features: int, widths: Sequence[int], generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_hidden = len(widths) - 1
        for i, w in enumerate(widths):
            self.add_module(f"fc{i}", QDense(in_features, w, generator=generator))
            if i < self.n_hidden:
                self.add_module(f"bn{i}", BatchNorm(w))
            in_features = w

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x), train))
        return getattr(self, f"fc{self.n_hidden}")(x)


def ordering(method: str) -> str:
    """Where a method's act site sits: 'ours' before the relu, 'after' it,
    'none' without one (the digit net's method-dependent layer order)."""
    if method in ("ours", "uniform_admm"):
        return "ours"
    return "after" if method in ("dorefa", "uniform", "llsq", "bwn", "bwnf") else "none"


class MNISTModelQuant(nn.Module):
    """The digit DANN CNN: two 5x5 VALID convs with biases (32 and 48
    channels), each BatchNorm, act site, relu and a 2x2 max pool in the
    method's order, channel dropout on the second; a 100-100-10 classifier
    and a 100-2 discriminator (on the reversed feature). A 1-channel image
    is tiled to 3. dropout_rate 0.0 turns the dropout off."""

    def __init__(self, w_bit: int = 8, a_bit: int = 8, method: str = "ours", variant: str = "b",
                 act_range: float = 2.0, admm: bool = False, cdf_impl: str = "erf", dropout_rate: float = 0.5,
                 img_size: int = 28, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ordering = ordering(method)
        kw = dict(w_bit=w_bit, a_bit=a_bit, method=method, variant=variant, use_bias=True, generator=generator)
        act_kw = dict(a_bit=a_bit, act_range=act_range, method=method, variant=variant, admm=admm,
                      cdf_impl=cdf_impl, generator=generator)
        side = img_size
        for name, cin, cout in (("conv1", 3, 32), ("conv2", 32, 48)):
            self.add_module(name, QConv(cin, cout, 5, 1, 0, **kw))
            self.add_module(f"{name}_bn", BatchNorm(cout))
            if self.ordering != "none":
                self.add_module(f"{name}_actq", QuantAct(**act_kw))
            side = (side - 4) // 2
        self.dropout = Dropout(dropout_rate, broadcast_dims=(2, 3))  # channel dropout, on conv2
        features = 48 * side * side
        self.classifier = GRLMlp(features, (100, 100, 10), generator)
        self.discriminator = GRLMlp(features, (100, 2), generator)
        name_sites(self)

    def _block(self, x, name, train, sink, rng, dropout: bool):
        x = getattr(self, f"{name}_bn")(getattr(self, name)(x), train)
        if self.ordering == "ours":
            x = getattr(self, f"{name}_actq")(x, sink)
        if dropout:
            x = self.dropout(x, train, rng)
        x = torch.relu(x)
        if self.ordering == "after":
            x = getattr(self, f"{name}_actq")(x, sink)
        return F.max_pool2d(x, 2, 2)

    def forward(self, x: torch.Tensor, alpha=1.0, train: bool = False, sink: Sink = None, rng: Rng = None):
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        x = x.permute(0, 3, 1, 2)
        x = self._block(x, "conv1", train, sink, rng, dropout=False)
        x = self._block(x, "conv2", train, sink, rng, dropout=True)
        feature = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's (h, w, c) order
        return self.classifier(feature, train), self.discriminator(gradient_reversal(feature, alpha), train)


def resnet50_dann(bitW: int = 8, abitW: int = 8, method: str = "ours", admm: bool = False, **kw) -> DANN:
    return DANN(arch="resnet50", w_bit=bitW, a_bit=abitW, method=method, admm=admm, **kw)


def resnet34_dann(bitW: int = 8, abitW: int = 8, method: str = "ours", admm: bool = False, **kw) -> DANN:
    return DANN(arch="resnet34", w_bit=bitW, a_bit=abitW, method=method, admm=admm, **kw)


def resnet18_dann(bitW: int = 8, abitW: int = 8, method: str = "ours", admm: bool = False, **kw) -> DANN:
    return DANN(arch="resnet18", w_bit=bitW, a_bit=abitW, method=method, admm=admm, **kw)


def resnet50_dsan(bitW: int = 8, abitW: int = 8, method: str = "ours", admm: bool = False, **kw) -> DSAN:
    return DSAN(arch="resnet50", w_bit=bitW, a_bit=abitW, method=method, admm=admm, **kw)


def mnist_model_quant(bitW: int = 8, abitW: int = 8, method: str = "ours", admm: bool = False,
                      **kw) -> MNISTModelQuant:
    return MNISTModelQuant(w_bit=bitW, a_bit=abitW, method=method, admm=admm, **kw)
