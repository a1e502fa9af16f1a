"""Straight-through-estimator rounding (port of alignq_tpu/quant/ste.py).

Each JAX custom_vjp is a torch.autograd.Function with an exact forward
(torch.round, half to even like jnp.round) and the same backward. The
exact forward matters: quantized residual adds produce exact-zero ties
(act_q1 == -shortcut), where relu's gradient branch is decided by whether
the sum is exactly 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from alignq_tpu_torch.quant.cdf import _clip


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _SignSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.sign(x)

    @staticmethod
    def backward(ctx, g):
        return g


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest (half to even) with an identity gradient."""
    return _RoundSTE.apply(x)


def sign_ste(x: torch.Tensor) -> torch.Tensor:
    """Sign with an identity gradient (the 1-bit case)."""
    return _SignSTE.apply(x)


# How uniform_quantize dequantizes: 'recip' (the default) or 'div', set
# only by dequant_division. Read at every call (the port is eager; the JAX
# package's mode is fixed when a function is traced).
_DEQUANT_MODE = "recip"


class dequant_division:
    """Context manager: inside it, uniform_quantize dequantizes by true
    division, round(x * n) / n (the reference's literal grid values), for
    parity harnesses; the reciprocal multiply is back on exit, also on an
    exception. It reaches every caller of uniform_quantize (fake_quant.py,
    the baselines' grids) and not APoT's own uniform grid, which divides
    by its reciprocal in either mode, as jitted JAX does."""

    def __enter__(self):
        global _DEQUANT_MODE
        self._prev = _DEQUANT_MODE
        _DEQUANT_MODE = "div"

    def __exit__(self, *exc):
        global _DEQUANT_MODE
        _DEQUANT_MODE = self._prev


def uniform_quantize(x: torch.Tensor, k: int, n: Optional[int] = None) -> torch.Tensor:
    """k-bit uniform fake quantization with STE backward: identity at
    k == 32, sign at k == 1, else round(x * n) * (1/n) with n = 2^k - 1
    steps (or the given n, e.g. 127 for the symmetric int8 deploy grid).

    Dequantized by the reciprocal multiply, as the JAX package does: one
    correctly rounded op, so grid values are the same in every execution
    mode, and the exact-zero residual ties stay exact (`/ n` moved
    gradients by O(1e-2) there in the JAX package's measurements). Under
    dequant_division, by `/ n`."""
    if k == 32:
        return x
    if k == 1:
        return sign_ste(x)
    n = float(n if n is not None else 2**k - 1)
    if _DEQUANT_MODE == "div":
        return round_ste(x * n) / n
    return round_ste(x * n) * (1.0 / n)


def _requant_grid(x: torch.Tensor, act_scale: float, m: int, g: int, signed: bool) -> torch.Tensor:
    k = torch.round(x * (1.0 / act_scale)).to(torch.int32)
    c = torch.clamp(torch.div(2 * k + m, 2 * m, rounding_mode="floor"), -g if signed else 0, g)
    return c.to(x.dtype) * (m * act_scale)


class _RequantGridSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, act_scale, m, g, signed):
        ctx.save_for_backward(x)
        ctx.lim = g * m * act_scale
        ctx.signed = signed
        return _requant_grid(x, act_scale, m, g, signed)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        lo = -ctx.lim if ctx.signed else 0.0
        mask = (x >= lo) & (x <= ctx.lim)
        return torch.where(mask, grad, torch.zeros_like(grad)), None, None, None, None


def requant_grid_ste(x: torch.Tensor, act_scale: float, m: int, g: int, signed: bool = False) -> torch.Tensor:
    """Deploy-exact requantization of a residual stream of act-grid values
    (x == K * act_scale) onto the block-input grid m * act_scale: K is
    recovered exactly, requantized in integers as (2K + m) // (2m) (round
    half up, as the INT graph's _requant_codes), clipped to [0, g] (or
    [-g, g] when signed), and returned as c * (m * act_scale).

    Gradient: straight through inside the clip range, 0 beyond it."""
    return _RequantGridSTE.apply(x, act_scale, m, g, signed)


def requant_ste(x: torch.Tensor, scale, g: int) -> torch.Tensor:
    """Deploy-exact linear requantization: clip(x, -g*scale, g*scale),
    rounded to the grid of `scale` by round_ste. `scale` is a Python float
    (the INT graph's stem-input site) or a (C,) tensor of per-channel
    scales over x's channel axis, axis 1 (a StageRequant site's calibrated
    scales; the JAX package broadcasts them over NHWC's last axis).

    The scale is applied as xc * (1 / scale), elementwise, as the JAX
    package does. The clip is an ordinary differentiated op: gradient 1
    inside, 0 outside, and 1/2 where x equals a bound exactly (jnp.clip's
    tie, which the port follows; torch.clamp would give 1)."""
    if torch.is_tensor(scale) and scale.ndim == 1:
        scale = scale.reshape((1, -1) + (1,) * (x.ndim - 2))
    lim = g * scale
    xc = _clip(x, -lim, lim)
    return round_ste(xc * (1.0 / scale)) * scale
