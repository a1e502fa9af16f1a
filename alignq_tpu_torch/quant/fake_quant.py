"""AlignQ CDF-alignment fake quantizers (port of
alignq_tpu/quant/fake_quant.py).

- weights: c = 2*Phi_{mean(w),std(w)}(w) - 1 (variant b; variant a keeps
  Phi in [0, 1] and maps the rounded value back by *2-1; variant int8
  rounds on the symmetric 2^(k-1)-1 deploy grid);
- activations: the same map against a fixed N(0,1) prior (the input is
  post-BatchNorm), scaled by act_range.

Only the rounding is straight through: the CDF map, including mean(w) and
std(w), is differentiated as an ordinary graph.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from alignq_tpu_torch.quant.cdf import cdf_transform, channel_stats, erf_sqrt2, tensor_stats
from alignq_tpu_torch.quant.ste import uniform_quantize


class WeightQuantResult(NamedTuple):
    """The quantized weight and the CDF/PDF values the PDF-corrected
    optimizer uses (it recomputes them from the live weights)."""

    wq: torch.Tensor
    cdf: torch.Tensor
    pdf: torch.Tensor


def quantize_weight(
    w: torch.Tensor,
    w_bit: int,
    *,
    variant: str = "b",
    grid_n: Optional[int] = None,
    channelwise: bool = False,
    channel_axis: int = -1,
) -> WeightQuantResult:
    """CDF-alignment fake-quantize a weight tensor.

    grid_n overrides the rounding grid; channelwise takes per-output-channel
    statistics over every axis but `channel_axis` (-1 for HWIO, 0 for the
    OIHW kernels of the port's layers)."""
    if w_bit == 32:
        return WeightQuantResult(w, w, w)
    mean, std = channel_stats(w, channel_axis) if channelwise else tensor_stats(w)
    if variant == "a":
        c, pdf = cdf_transform(w, mean, std, affine=False)
        wq = uniform_quantize(c, w_bit, grid_n) * 2.0 - 1.0
    elif variant == "b":
        c, pdf = cdf_transform(w, mean, std, affine=True)
        wq = uniform_quantize(c, w_bit, grid_n)
    elif variant == "int8":
        c, pdf = cdf_transform(w, mean, std, affine=True)
        wq = uniform_quantize(c, w_bit, 2 ** (w_bit - 1) - 1)
    else:
        raise ValueError(f"unknown quantizer variant {variant!r}")
    return WeightQuantResult(wq, c, pdf)


def _act_c(a: torch.Tensor, variant: str, impl: str, act_range: Optional[float]) -> torch.Tensor:
    """The continuous act-site transform c. The poly impl computes
    c = erf_sqrt2_poly(a) directly (2*Phi - 1 under the N(0,1) prior), the
    expression the INT graph's poly epilogue evaluates."""
    if variant == "a":
        c, _ = cdf_transform(a, 0.0, 1.0, affine=False, impl=impl)
        return c
    if impl == "erf":
        c, _ = cdf_transform(a, 0.0, 1.0, affine=True, act_range=act_range, impl=impl)
        return c
    c = erf_sqrt2(a, impl)
    return c * act_range if act_range is not None else c


def quantize_act(
    a: torch.Tensor,
    a_bit: int,
    *,
    act_range: float = 2.0,
    variant: str = "b",
    grid_n: Optional[int] = None,
    impl: str = "erf",
) -> torch.Tensor:
    """CDF-alignment fake-quantize activations against a fixed N(0,1)
    prior. impl 'poly' must be deployed with the same grid."""
    if a_bit == 32:
        return a
    if variant == "a":
        c = _act_c(a, "a", impl, None)
        return (uniform_quantize(c, a_bit, grid_n) * 2.0 - 1.0) * act_range
    if variant == "b":
        return uniform_quantize(_act_c(a, "b", impl, act_range), a_bit, grid_n)
    if variant == "int8":
        # act_range outside the rounding: act_range * code / g with
        # code = round((2*Phi - 1) * g), the INT graph's act codes
        return uniform_quantize(_act_c(a, "int8", impl, None), a_bit, 2 ** (a_bit - 1) - 1) * act_range
    raise ValueError(f"unknown quantizer variant {variant!r}")


def act_cdf(a: torch.Tensor, *, act_range: float = 2.0, variant: str = "b", impl: str = "erf") -> torch.Tensor:
    """The continuous CDF value of an activation (before rounding): what
    the ADMM correlation compares the activation with."""
    if variant == "a":
        return _act_c(a, "a", impl, None)
    return _act_c(a, "b", impl, act_range)
