"""Gradient reversal (port of alignq_tpu/nn/grl.py): the identity forward,
-alpha * g backward, and no gradient for alpha."""

from __future__ import annotations

import torch


class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = float(alpha)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * (-ctx.alpha), None


def gradient_reversal(x: torch.Tensor, alpha) -> torch.Tensor:
    """x forward; -alpha * g backward (alpha a host scalar)."""
    return _GradientReversal.apply(x, alpha)
