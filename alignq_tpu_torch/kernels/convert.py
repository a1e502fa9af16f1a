"""Freeze conv+BN pairs into the INT8 inference form (port of
alignq_tpu/kernels/convert.py:27-74).

- weight: c = 2*Phi_{mean(w),std(w)}(w) - 1; q = round(c * g) int8;
- BatchNorm folds into a per-channel (scale, bias) epilogue on the int32
  accumulator:
      scale_c = act_scale * w_scale * gamma_c / sqrt(var_c + eps)
      bias_c  = beta_c - gamma_c * mu_c / sqrt(var_c + eps)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from alignq_tpu_torch.quant.cdf import channel_stats, gaussian_cdf, tensor_stats

W_SCALE = 1.0 / 127.0


def grid_max(bits: int) -> int:
    """Symmetric code bound: 127 for int8, 7 for int4 (2^{b-1}-1)."""
    return 2 ** (bits - 1) - 1


class QConvInt8(NamedTuple):
    kernel_int8: torch.Tensor  # HWIO integer codes (int8 storage)
    scale: torch.Tensor  # (Cout,) f32 fused dequant * BN scale
    bias: torch.Tensor  # (Cout,) f32 fused BN shift


def quantize_weight_int8(w: torch.Tensor, bits: int = 8, channelwise: bool = False) -> torch.Tensor:
    """CDF-align then symmetric integer codes in [-g, g], stored int8."""
    mean, std = channel_stats(w) if channelwise else tensor_stats(w)
    c = 2.0 * gaussian_cdf(w, mean, std) - 1.0
    g = float(grid_max(bits))
    return torch.clamp(torch.round(c * g), -g, g).to(torch.int8)


def fold_conv_bn(
    kernel: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    act_scale: float,
    eps: float = 1e-5,
    bits: int = 8,
) -> QConvInt8:
    """Freeze one conv+bn pair into (integer kernel, per-channel scale/bias)."""
    k_int8 = quantize_weight_int8(kernel, bits)
    inv = bn_scale / torch.sqrt(bn_var + eps)
    scale = act_scale * (1.0 / grid_max(bits)) * inv
    bias = bn_bias - bn_mean * inv
    return QConvInt8(k_int8, scale.float(), bias.float())
