"""Digit domain-adaptation data (port of alignq_tpu/data/digits.py):
MNIST (idx), MNIST-M (pickle), SVHN (.mat) and SynDigits (ImageFolder)
where their files exist, else a synthetic domain; every image resized by
nearest neighbour to img_size, tiled to 3 channels and normalized to mean
and std 0.5. Batches equal the JAX package's array for array."""

from __future__ import annotations

import os
import pickle

import numpy as np

from alignq_tpu_torch.data import datasets
from alignq_tpu_torch.data.loader import ArrayLoader
from alignq_tpu_torch.data.office import load_image_folder, split_train_test, synthetic_domain

DIGIT_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
DIGIT_STD = np.array([0.5, 0.5, 0.5], np.float32)


def _resize_nearest(x: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour resize of an NHWC batch."""
    _, h, w, _ = x.shape
    if h == size and w == size:
        return x
    ri = (np.arange(size) * h // size).clip(0, h - 1)
    ci = (np.arange(size) * w // size).clip(0, w - 1)
    return x[:, ri][:, :, ci]


def _to_rgb(x: np.ndarray) -> np.ndarray:
    return np.repeat(x, 3, axis=-1) if x.shape[-1] == 1 else x


def load_mnistm(data_dir: str):
    """The MNIST-M pickle ({'train', 'valid', 'test'} of images and
    labels), or None."""
    for cand in (os.path.join(data_dir, "mnistm", "mnist_m_data.pkl"), os.path.join(data_dir, "mnist_m_data.pkl"),
                 os.path.join(data_dir, "MNISTM", "processed", "mnist_m_data.pkl")):
        if os.path.isfile(cand):
            with open(cand, "rb") as f:
                return pickle.load(f)
    return None


def get_digit_domain(name: str, data_dir: str, batch_size: int, *, train: bool, img_size: int = 28,
                     seed: int = 0) -> ArrayLoader:
    """One digit domain ('mnist' | 'mnistm' | 'svhn' | 'syndigits'); where
    its files are absent, 2048 synthetic images of 10 classes, 90% of them
    the train split."""
    name = name.lower()
    arrays = None
    if name == "mnist":
        arrays = datasets.load_mnist(data_dir)
    elif name == "svhn":
        arrays = datasets.load_svhn(data_dir)
    elif name == "mnistm":
        d = load_mnistm(data_dir)
        if d is not None:
            arrays = (d["train"]["images"], d["train"]["labels"], d["test"]["images"], d["test"]["labels"])
    elif name == "syndigits":
        loaded = load_image_folder(os.path.join(data_dir, "syndigits"), image_size=img_size)
        if loaded is not None:
            x_all, y_all = loaded
            tr, te = split_train_test(len(x_all), 0.9, seed=1)
            arrays = (x_all[tr], y_all[tr], x_all[te], y_all[te])
    if arrays is None:
        x, y = synthetic_domain(name, 2048, num_classes=10, image_size=img_size, seed=seed)
        k = int(len(x) * 0.9)
        arrays = (x[:k], y[:k], x[k:], y[k:])
    tx, ty, ex, ey = arrays
    x, y = (tx, ty) if train else (ex, ey)
    x = _resize_nearest(_to_rgb(np.asarray(x)), img_size)

    def norm(b):
        return (b.astype(np.float32) / 255.0 - DIGIT_MEAN) / DIGIT_STD

    return ArrayLoader(x, np.asarray(y, np.int32), batch_size, shuffle=train, drop_remainder=True, transform_fn=norm,
                       seed=seed)
