"""Dataset registry: name -> Data(loader_train, loader_test) (port of
alignq_tpu/data/registry.py: 'cifar10', with the synthetic set where the
pickles are absent, and 'synthetic')."""

from __future__ import annotations

import logging

import numpy as np

from alignq_tpu_torch.data import datasets
from alignq_tpu_torch.data.augment import augment_normalize, normalize
from alignq_tpu_torch.data.loader import ArrayLoader, Data

log = logging.getLogger(__name__)


def _cifar_like(arrays, train_bs: int, eval_bs: int, seed: int, mean: np.ndarray, std: np.ndarray) -> Data:
    tx, ty, ex, ey = arrays
    train = ArrayLoader(tx, ty, train_bs, shuffle=True, drop_remainder=True,
                        augment_fn=lambda b, rng: augment_normalize(b, rng, mean, std), seed=seed)
    test = ArrayLoader(ex, ey, eval_bs, shuffle=False, drop_remainder=True,
                       transform_fn=lambda b: normalize(b, mean, std))
    return Data(train, test)


def get_data(name: str, data_dir: str, train_batch_size: int, eval_batch_size: int, seed: int = 0) -> Data:
    """RandomCrop(32, 4) + flip + normalize on the train split, normalize
    on the test split; drop-remainder batches."""
    name = name.lower()
    if name == "cifar10":
        arrays = datasets.load_cifar10(data_dir)
        if arrays is None:
            log.warning("cifar10 not found under %s: using synthetic data", data_dir)
            arrays = datasets.synthetic(seed=seed)
    elif name == "synthetic":
        arrays = datasets.synthetic(seed=seed)
    else:
        raise ValueError(f"unknown dataset {name!r}; the port has 'cifar10' and 'synthetic'")
    return _cifar_like(arrays, train_batch_size, eval_batch_size, seed, datasets.CIFAR10_MEAN, datasets.CIFAR10_STD)
