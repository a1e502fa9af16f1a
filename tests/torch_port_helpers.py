"""Shared inputs of the tests/test_torch_*.py files."""

import numpy as np
import torch

from alignq_tpu_torch import interop


def random_preact_tree(depth, seed):
    """A flax-layout PreActResNet (params, batch_stats) of the given depth,
    every leaf drawn with numpy: fan-in-scaled uniform kernels and
    non-trivial BN scale, shift, mean and variance."""
    shapes, stat_shapes = interop.init_preact_resnet_params(depth, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(seed)

    def draw(tree):
        out = {}
        for k, v in tree.items():
            shape = tuple(v.shape) if torch.is_tensor(v) else None
            if shape is None:
                out[k] = draw(v)
            elif k == "kernel":
                out[k] = (rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
            elif k in ("scale", "var"):
                out[k] = (rng.rand(*shape) + 0.5).astype(np.float32)
            else:  # bias, mean
                out[k] = (rng.randn(*shape) * 0.2).astype(np.float32)
        return out

    return draw(shapes), draw(stat_shapes)
