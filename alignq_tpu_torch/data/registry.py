"""Dataset registry: name -> Data(loader_train, loader_test) (port of
alignq_tpu/data/registry.py: 'cifar10' and 'svhn', each with the synthetic
set where its files are absent, and 'synthetic')."""

from __future__ import annotations

import logging

import numpy as np

from alignq_tpu_torch.data import datasets
from alignq_tpu_torch.data.augment import augment_normalize, normalize
from alignq_tpu_torch.data.loader import ArrayLoader, Data

log = logging.getLogger(__name__)


def _cifar_like(arrays, train_bs: int, eval_bs: int, seed: int, mean: np.ndarray, std: np.ndarray,
                train_augment: bool = True) -> Data:
    tx, ty, ex, ey = arrays
    if train_augment:
        train = ArrayLoader(tx, ty, train_bs, shuffle=True, drop_remainder=True,
                            augment_fn=lambda b, rng: augment_normalize(b, rng, mean, std), seed=seed)
    else:
        train = ArrayLoader(tx, ty, train_bs, shuffle=True, drop_remainder=True,
                            transform_fn=lambda b: normalize(b, mean, std), seed=seed)
    test = ArrayLoader(ex, ey, eval_bs, shuffle=False, drop_remainder=True,
                       transform_fn=lambda b: normalize(b, mean, std))
    return Data(train, test)


def get_data(name: str, data_dir: str, train_batch_size: int, eval_batch_size: int, seed: int = 0) -> Data:
    """RandomCrop(32, 4) + flip + normalize on the train split (SVHN:
    normalize only, as the reference's svhn.py), normalize on the test
    split; drop-remainder batches."""
    name = name.lower()
    loaders = {"cifar10": datasets.load_cifar10, "svhn": datasets.load_svhn, "synthetic": lambda _: None}
    if name not in loaders:
        raise ValueError(f"unknown dataset {name!r}; the port has {sorted(loaders)}")
    arrays = loaders[name](data_dir)
    if arrays is None:
        if name != "synthetic":
            log.warning("%s not found under %s: using synthetic data", name, data_dir)
        arrays = datasets.synthetic(seed=seed)
    if name == "svhn":
        return _cifar_like(arrays, train_batch_size, eval_batch_size, seed, datasets.SVHN_MEAN, datasets.SVHN_STD,
                           train_augment=False)
    return _cifar_like(arrays, train_batch_size, eval_batch_size, seed, datasets.CIFAR10_MEAN, datasets.CIFAR10_STD)
