"""The AlignQ PDF-corrected gradient rule (port of
alignq_tpu/optim/correction.py):

    T(c)      = ((c + 0.5) * (2^bitW - 1) mod 1) * lam2 * 2     (bin phase)
    sigma'(x) = sigmoid(x) * (1 - sigmoid(x)) * lam             (smooth d(round))
    u        <- u * sigma'(T(c)) * pdf(w)                       (on masked leaves)

with c = 2*Phi(w) - 1 and pdf = 2*phi(w) under w's own N(mean(w), std(w))
fit, recomputed from the live (pre-update) weights: the whole tensor's
statistics where w is a rank's slice of a column-parallel weight (the
optimizer enters its model axis, quant/cdf.py tensor_stats). This is the paper's
intended rule, applied after momentum (optim/factory.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from alignq_tpu_torch.quant.cdf import cdf_transform, channel_stats, tensor_stats


def correction_factor(w: torch.Tensor, w_bit: int, lam: float, lam2: float, channelwise: bool = False,
                      channel_axis: int = -1) -> torch.Tensor:
    """sigma'(T(c)) * pdf(w) of a weight tensor; channelwise (over every
    axis but channel_axis) must match the quantizer's statistics."""
    mean, std = channel_stats(w, channel_axis) if channelwise else tensor_stats(w)
    c, pdf = cdf_transform(w, mean, std, affine=True)
    t = torch.remainder((c + 0.5) * float(2**w_bit - 1), 1.0) * lam2 * 2.0
    sig = torch.sigmoid(t)
    return sig * (1.0 - sig) * lam * pdf


def build_correction_mask(params: Dict[str, torch.Tensor], exclude: Tuple[str, ...] = ()) -> Dict[str, bool]:
    """{name: corrected} over named parameters: every 4-D conv `kernel`,
    minus those whose '/'-joined path is an excluded prefix from the root
    ('conv0' drops the stem, not `layers_0/conv0`)."""

    def flagged(name: str, leaf: torch.Tensor) -> bool:
        keys = name.split(".")
        joined = "/".join(keys)
        if keys[-1] != "kernel" or leaf.ndim != 4:
            return False
        return not any(joined == e or joined.startswith(e + "/") for e in exclude)

    return {name: flagged(name, p) for name, p in params.items()}
