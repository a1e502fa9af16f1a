"""Batch-correlation matrices for ADMM correlation preservation (port of
alignq_tpu/admm/correlation.py).

x is (B, F), F = C*H*W flattened. The port flattens NCHW where the JAX
package flattens NHWC: corr is invariant to the order of the feature
columns, so both give the same B x B matrix up to summation order.
"""

from __future__ import annotations

import torch


def _safe_std(x: torch.Tensor) -> torch.Tensor:
    """Column std (ddof=1) whose gradient is 0, not NaN, for a column that
    is constant across the batch: the double where routes the zero-variance
    branch around sqrt, whose derivative is infinite at 0."""
    var = x.var(dim=0, correction=1)
    nz = var > 0.0
    return torch.where(nz, torch.sqrt(torch.where(nz, var, torch.ones_like(var))), torch.zeros_like(var))


def corr(x: torch.Tensor, y: torch.Tensor, *, eps: float = 0.0) -> torch.Tensor:
    """Pearson-style batch correlation: standardize columns, X @ Y^T / F.
    eps is added to each column's std (1e-5: the guarded form)."""
    x_std = (x - x.mean(dim=0)) / (_safe_std(x) + eps)
    y_std = (y - y.mean(dim=0)) / (_safe_std(y) + eps)
    return torch.matmul(x_std, y_std.t()) / x_std.shape[1]


def corr_discrepancy(x_feat: torch.Tensor, x_trans_feat: torch.Tensor, *, eps: float = 0.0) -> torch.Tensor:
    """D = corr(T(x)) - corr(x), the B x B discrepancy the ADMM loss takes,
    from the flattened activations before and after the CDF transform."""
    return corr(x_trans_feat, x_trans_feat, eps=eps) - corr(x_feat, x_feat, eps=eps)
