"""Vectorized numpy batch augmentation (port of alignq_tpu/data/augment.py
and of the numpy path of data/native_augment.py; the native C++ kernel's
binding is the port's data/native_augment.py).

RandomCrop(32, padding=4) + RandomHorizontalFlip + Normalize, drawing
from the loader's RandomState in the JAX package's order (crop offsets,
then flips), so the same seed gives the same batches."""

from __future__ import annotations

import numpy as np


def normalize(x: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 normalized (ToTensor + Normalize)."""
    return (x.astype(np.float32) / 255.0 - mean) / std


def random_crop_flip(x: np.ndarray, rng: np.random.RandomState, pad: int = 4) -> np.ndarray:
    """Batched pad-and-crop and horizontal flip of uint8 or float NHWC:
    the crop offsets drawn first (rows, then columns), then the flips."""
    n, h, w, _ = x.shape
    oy = rng.randint(0, 2 * pad + 1, n)
    ox = rng.randint(0, 2 * pad + 1, n)
    flip = rng.rand(n) < 0.5
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    rows = oy[:, None] + np.arange(h)[None, :]
    cols = ox[:, None] + np.arange(w)[None, :]
    out = xp[np.arange(n)[:, None, None], rows[:, :, None], cols[:, None, :]]
    out[flip] = out[flip, :, ::-1]
    return out


def augment_normalize(x: np.ndarray, rng: np.random.RandomState, mean: np.ndarray, std: np.ndarray,
                      pad: int = 4) -> np.ndarray:
    """Pad-and-crop, horizontal flip and normalize: uint8 NHWC -> float32 NHWC."""
    return normalize(random_crop_flip(x, rng, pad), mean, std)
