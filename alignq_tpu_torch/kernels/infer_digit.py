"""True-INT8 digit DANN (port of alignq_tpu/kernels/infer_digit.py), value
for value as the JAX package runs it under jit.

- conv1 and conv2 (5x5 VALID, with biases) fold with their BatchNorms into
  int8 convs with per-channel f32 epilogues, the conv bias absorbed into
  the BN mean (BN(Wx + b) is BN with mean - b);
- the image is quantized at S_DIGIT = 1/127 (the digit pipelines normalize
  to [-1, 1]) and padded to 4 channels; each conv, its relu'd act codes
  (max(code(h), 0)) and the 2x2 max pool of the codes after it are one
  launch of csrc/digit_sm90.cu on the card (kernels/digit.py conv_pool,
  after a prep pass for conv1), or the chain that kernel replaced (K1's
  5x5 form, then the pool: an amax over each window, exact on codes) on
  the CPU or where the kernel does not take the conv;
- the pooled conv2 codes times the act grid's scale are the feature, in
  flax's (h, w, c) order; the classifier and discriminator MLPs stay f32
  (torch.matmul, TF32 off, as JAX's Precision.HIGHEST), their BatchNorm1d
  statistics folded to affines, each applied as one f32 multiply-add.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from alignq_tpu_torch.kernels.convert import fold_conv_bn
from alignq_tpu_torch.kernels.digit import S_DIGIT, conv_pool
from alignq_tpu_torch.kernels.infer import _act_g
from alignq_tpu_torch.kernels.infer_resnet_imagenet import _f32
from alignq_tpu_torch.kernels.qmatmul import act_map, pack_conv_weights
from alignq_tpu_torch.quant.cdf import fma_f32


def _bn1d_affine(p: Dict[str, torch.Tensor], s: Dict[str, torch.Tensor], eps: float = 1e-5):
    inv = p["scale"] / torch.sqrt(s["var"] + eps)
    return {"scale": inv.float(), "bias": (p["bias"] - s["mean"] * inv).float()}


def convert_mnist_dann(params: Dict[str, Any], batch_stats: Dict[str, Any], weight_bits: int = 8,
                       act_bits: int = 8) -> Dict[str, Any]:
    """A trained MNISTModelQuant's flax-layout tree -> {'conv1', 'conv2'
    (QConvInt8), 'classifier' (fc0, bn0, fc1, bn1, fc2), 'discriminator'
    (fc0, bn0, fc1)}."""
    act_scale = 2.0 / _act_g(act_bits)

    def fold(conv, bn, in_scale):
        return fold_conv_bn(params[conv]["kernel"], params[bn]["scale"], params[bn]["bias"],
                            batch_stats[bn]["mean"] - params[conv]["bias"], batch_stats[bn]["var"],
                            act_scale=in_scale, bits=weight_bits)

    def mlp(name, n_bn):
        head = {f"fc{i}": dict(params[name][f"fc{i}"]) for i in range(n_bn + 1)}
        head.update({f"bn{i}": _bn1d_affine(params[name][f"bn{i}"], batch_stats[name][f"bn{i}"]) for i in range(n_bn)})
        return head

    return {"conv1": fold("conv1", "conv1_bn", S_DIGIT), "conv2": fold("conv2", "conv2_bn", act_scale),
            "classifier": mlp("classifier", 2), "discriminator": mlp("discriminator", 1)}


def pack_mnist_dann_operands(qparams: Dict[str, Any]) -> Dict[str, Any]:
    """Both convs laid out once for K1 (conv1's 3 channels padded to 4)."""
    return {k: pack_conv_weights(qparams[k].kernel_int8, qparams[k].scale, qparams[k].bias) for k in ("conv1", "conv2")}


def _mlp_forward(head: Dict[str, Any], x: torch.Tensor, n_bn: int) -> torch.Tensor:
    for i in range(n_bn):
        x = torch.matmul(x, head[f"fc{i}"]["kernel"]) + head[f"fc{i}"]["bias"]
        x = torch.relu(fma_f32(x, head[f"bn{i}"]["scale"], head[f"bn{i}"]["bias"]))
    return torch.matmul(x, head[f"fc{n_bn}"]["kernel"]) + head[f"fc{n_bn}"]["bias"]


def mnist_dann_int8_codes(qparams: Dict[str, Any], x: torch.Tensor, act_bits: int = 8, act_impl: str = "erf",
                          operands: Optional[Dict[str, Any]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pooled relu'd codes of conv1 (B, 12, 12, 32) and conv2 (B, 4,
    4, 48) int8 of NHWC images (28x28); on CUDA two launches of
    csrc/digit_sm90.cu (kernels/digit.py conv_pool)."""
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    ops = pack_mnist_dann_operands(qparams) if operands is None else operands
    relu = act_map(act_impl, int(_act_g(act_bits)), x.device, relu=True)
    c1 = conv_pool(1, x, ops["conv1"], relu)
    return c1, conv_pool(2, c1, ops["conv2"], relu)


def mnist_dann_int8_forward(qparams: Dict[str, Any], x: torch.Tensor, act_bits: int = 8, act_impl: str = "erf",
                            operands: Optional[Dict[str, Any]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(class logits, domain logits) of NHWC images; the GRL is the
    identity at inference, so both heads read one feature. operands:
    pack_mnist_dann_operands(qparams), made once; None lays them out here."""
    _, c2 = mnist_dann_int8_codes(qparams, x, act_bits, act_impl, operands)
    feat = c2.to(torch.float32).reshape(c2.shape[0], -1) * _f32(2.0 / _act_g(act_bits))
    return _mlp_forward(qparams["classifier"], feat, 2), _mlp_forward(qparams["discriminator"], feat, 1)
