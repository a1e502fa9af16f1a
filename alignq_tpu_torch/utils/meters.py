"""Running-statistics meters and top-k accuracy (port of
alignq_tpu/utils/meters.py)."""

from __future__ import annotations

import numpy as np


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def _numpy(a) -> np.ndarray:
    """A tensor (any device, any float type) or an array as numpy."""
    if hasattr(a, "detach"):
        a = a.detach().cpu()
        if a.is_floating_point() and a.dtype.itemsize < 4:  # numpy has no bfloat16
            a = a.float()
        a = a.numpy()
    return np.asarray(a)


def accuracy_topk(logits, labels, topk=(1,)):
    """Top-k accuracy in percent of (N, classes) logits against (N,)
    labels, tensors or arrays. Ranked by numpy's default argsort of the
    negated logits, as the JAX package ranks them, so that rows with tied
    logits (an INT graph's quantized logits tie) count as they count there,
    not as torch.topk would break the ties."""
    logits, labels = _numpy(logits), _numpy(labels)
    maxk = max(topk)
    pred = np.argsort(-logits, axis=-1)[:, :maxk]
    correct = pred == labels[:, None]
    return [float(correct[:, :k].any(-1).mean() * 100.0) for k in topk]
