"""Raw dataset loading (port of alignq_tpu/data/datasets.py: CIFAR-10's
python pickles, SVHN's .mat files, MNIST's idx files and the synthetic set). Numpy only; the port keeps its own
copy so that it imports nothing of the JAX package. The same seed gives the
same arrays as the JAX package's `synthetic`."""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Optional, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

# torchvision normalization constants used by the reference
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)
SVHN_MEAN = np.array([0.5, 0.5, 0.5], np.float32)  # the reference's svhn.py:15-22
SVHN_STD = np.array([0.5, 0.5, 0.5], np.float32)


def load_cifar10(data_dir: str) -> Optional[Arrays]:
    """cifar-10-batches-py pickles under data_dir -> uint8 NHWC, or None
    where they are absent."""
    base = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(base):
        return None

    def read_batch(name):
        with open(os.path.join(base, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x, np.asarray(d[b"labels"], np.int32)

    xs, ys = zip(*(read_batch(f"data_batch_{i}") for i in range(1, 6)))
    tx, ty = read_batch("test_batch")
    return np.concatenate(xs), np.concatenate(ys), tx, ty


def load_svhn(data_dir: str) -> Optional[Arrays]:
    """SVHN's cropped digits (train_32x32.mat, test_32x32.mat under
    data_dir) -> uint8 NHWC, labels 0-9 (the files' 10 is the digit 0), or
    None where they are absent."""
    tr, te = os.path.join(data_dir, "train_32x32.mat"), os.path.join(data_dir, "test_32x32.mat")
    if not (os.path.isfile(tr) and os.path.isfile(te)):
        return None
    from scipy.io import loadmat

    def read(path):
        m = loadmat(path)
        return np.transpose(m["X"], (3, 0, 1, 2)), m["y"].reshape(-1).astype(np.int32) % 10  # HWCN -> NHWC

    return (*read(tr), *read(te))


def _read_idx(path: str) -> np.ndarray:
    """An idx file (optionally gzipped) as a uint8 array of its shape."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        ndim = struct.unpack(">I", f.read(4))[0] & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def load_mnist(data_dir: str, prefix: str = "") -> Optional[Arrays]:
    """MNIST's idx files (optionally gzipped, under data_dir/prefix or
    data_dir/MNIST/raw) -> uint8 NHW1, int32 labels; None where any is
    absent."""
    names = {"train_x": "train-images-idx3-ubyte", "train_y": "train-labels-idx1-ubyte",
             "test_x": "t10k-images-idx3-ubyte", "test_y": "t10k-labels-idx1-ubyte"}
    found = {}
    for k, n in names.items():
        cands = [os.path.join(data_dir, prefix, n), os.path.join(data_dir, prefix, n + ".gz"),
                 os.path.join(data_dir, "MNIST", "raw", n), os.path.join(data_dir, "MNIST", "raw", n + ".gz")]
        hit = next((c for c in cands if os.path.isfile(c)), None)
        if hit is None:
            return None
        found[k] = hit
    return (_read_idx(found["train_x"])[..., None], _read_idx(found["train_y"]).astype(np.int32),
            _read_idx(found["test_x"])[..., None], _read_idx(found["test_y"]).astype(np.int32))


def synthetic(n_train: int = 2048, n_test: int = 512, shape: Tuple[int, int, int] = (32, 32, 3),
              num_classes: int = 10, seed: int = 0) -> Arrays:
    """Deterministic, learnable synthetic image classification data: each
    class a fixed low-frequency template, each sample template + noise,
    quantized to uint8."""
    rng = np.random.RandomState(seed)
    h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    templates = []
    for _ in range(num_classes):
        fx, fy = rng.uniform(0.5, 2.5, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        base = np.sin(2 * np.pi * fx * xx / w + px) * np.cos(2 * np.pi * fy * yy / h + py)
        templates.append(np.stack([base * rng.uniform(0.5, 1.0) for _ in range(c)], -1))
    templates = np.stack(templates)  # (K, H, W, C)

    def make(n, seed_off):
        r = np.random.RandomState(seed + seed_off)
        y = r.randint(0, num_classes, n).astype(np.int32)
        x = templates[y] * 0.5 + r.randn(n, h, w, c).astype(np.float32) * 0.25
        x = np.clip((x + 1.0) / 2.0, 0, 1)
        return (x * 255).astype(np.uint8), y

    tx, ty = make(n_train, 1)
    ex, ey = make(n_test, 2)
    return tx, ty, ex, ey
