"""MDD, Margin Disparity Discrepancy (port of alignq_tpu/models/mdd.py):
the trunk, a bottleneck (fc -> BatchNorm -> relu -> dropout), a class MLP
and an adversarial MLP on the reversed feature, and the MDD objective. The
reversal's coefficient is annealed by mdd_grl_coeff and passed in."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from alignq_tpu_torch.models.dann import Sink, _trunk, name_sites
from alignq_tpu_torch.nn.dropout import Dropout, Rng
from alignq_tpu_torch.nn.grl import gradient_reversal
from alignq_tpu_torch.nn.layers import BatchNorm, QDense


def mdd_grl_coeff(iter_num, alpha: float = 1.0, low: float = 0.0, high: float = 0.1, max_iter: float = 1000.0,
                  dtype=torch.float32) -> float:
    """coeff(i) = 2 (hi - lo) / (1 + exp(-alpha i / max_iter)) - (hi - lo) + lo,
    the exp and what follows in `dtype` (JAX's jnp, f32 but under x64), the
    exponent's argument in Python's double as JAX's."""
    e = torch.exp(torch.tensor(-alpha * iter_num / max_iter, dtype=dtype))
    return float(torch.tensor(2.0 * (high - low), dtype=dtype) / (1.0 + e) - (high - low) + low)


class _MLPHead(nn.Module):
    def __init__(self, in_features: int, width: int, num_classes: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc0 = QDense(in_features, width, generator=generator)
        self.dropout = Dropout(0.5)
        self.fc1 = QDense(width, num_classes, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False, rng: Rng = None) -> torch.Tensor:
        return self.fc1(self.dropout(torch.relu(self.fc0(x)), train, rng))


class MDDNet(nn.Module):
    """Returns (features, outputs, softmax(outputs), outputs_adv). The
    dropouts draw in the order JAX's run them: the bottleneck's, the
    adversarial head's, the class head's."""

    def __init__(self, arch: str = "resnet50", num_classes: int = 31, bottleneck_dim: int = 1024,
                 width: int = 1024, use_bottleneck: bool = True, w_bit: int = 8, a_bit: int = 8,
                 method: str = "ours", variant: str = "b", act_range: float = 2.0, admm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_bottleneck = use_bottleneck
        self.base_network = _trunk(arch, generator, bitW=w_bit, abitW=a_bit, method=method, admm=admm,
                                   variant=variant, act_range=act_range)
        features = self.base_network.features
        if use_bottleneck:
            self.bottleneck_fc = QDense(features, bottleneck_dim, generator=generator)
            self.bottleneck_bn = BatchNorm(bottleneck_dim)
            self.bottleneck_dropout = Dropout(0.5)
            features = bottleneck_dim
        self.classifier = _MLPHead(features, width, num_classes, generator)
        self.classifier_adv = _MLPHead(features, width, num_classes, generator)
        name_sites(self)

    def forward(self, x: torch.Tensor, grl_coeff=0.1, train: bool = False, sink: Sink = None, rng: Rng = None):
        features = self.base_network(x, train, sink)
        if self.use_bottleneck:
            features = torch.relu(self.bottleneck_bn(self.bottleneck_fc(features), train))
            features = self.bottleneck_dropout(features, train, rng)
        outputs_adv = self.classifier_adv(gradient_reversal(features, grl_coeff), train, rng)
        outputs = self.classifier(features, train, rng)
        return features, outputs, torch.softmax(outputs, dim=-1), outputs_adv


def mdd_loss(outputs: torch.Tensor, outputs_adv: torch.Tensor, labels_source: torch.Tensor,
             srcweight: float = 3.0) -> torch.Tensor:
    """The source classifier's CE plus the margin terms over the
    concatenated [source; target] outputs: srcweight * CE of the
    adversarial head at the class head's argmax on the source, and the NLL
    of log(1 - softmax) (clipped at 1e-6) at it on the target."""
    n_src = labels_source.shape[0]
    classifier_loss = F.cross_entropy(outputs[:n_src], labels_source.long())
    target_adv = torch.argmax(outputs, dim=-1)
    adv_src = F.cross_entropy(outputs_adv[:n_src], target_adv[:n_src])
    p_tgt = torch.softmax(outputs_adv[n_src:], dim=-1)
    log1m = torch.log(torch.clamp_min(1.0 - p_tgt, 1e-6))
    adv_tgt = -torch.mean(torch.gather(log1m, 1, target_adv[n_src:, None]))
    return classifier_loss + (srcweight * adv_src + adv_tgt)


def mddnet(bitW: int = 8, abitW: int = 8, method: str = "ours", admm: bool = False, **kw) -> MDDNet:
    return MDDNet(w_bit=bitW, a_bit=abitW, method=method, admm=admm, **kw)
