"""Dataset registry: name -> Data(loader_train, loader_test) (port of
alignq_tpu/data/registry.py: 'cifar10' and 'svhn', each with the synthetic
set where its files are absent, and 'synthetic'). The batches take the
native kernel only where the caller passes a built library
(`native_library`, from data/native_augment.py build), numpy's path
otherwise, with the same draws either way: a library left in a build
directory by an earlier run changes no later run's batches."""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from alignq_tpu_torch.data import augment, datasets, native_augment
from alignq_tpu_torch.data.loader import ArrayLoader, Data

log = logging.getLogger(__name__)


def _cifar_like(arrays, train_bs: int, eval_bs: int, seed: int, mean: np.ndarray, std: np.ndarray,
                train_augment: bool = True, native_library=None) -> Data:
    tx, ty, ex, ey = arrays
    if native_library is None:
        def aug(b, rng):
            return augment.augment_normalize(b, rng, mean, std)

        def norm(b):
            return augment.normalize(b, mean, std)
    else:
        native_augment.load(native_library)  # a library asked for and missing raises here

        def aug(b, rng):
            return native_augment.augment_normalize(b, rng, mean, std, library=native_library)

        def norm(b):
            return native_augment.normalize_only(b, mean, std, library=native_library)

    if train_augment:
        train = ArrayLoader(tx, ty, train_bs, shuffle=True, drop_remainder=True, augment_fn=aug, seed=seed)
    else:
        train = ArrayLoader(tx, ty, train_bs, shuffle=True, drop_remainder=True, transform_fn=norm, seed=seed)
    test = ArrayLoader(ex, ey, eval_bs, shuffle=False, drop_remainder=True, transform_fn=norm)
    return Data(train, test)


def get_data(name: str, data_dir: str, train_batch_size: int, eval_batch_size: int, seed: int = 0,
             native_library: Optional[str] = None) -> Data:
    """RandomCrop(32, 4) + flip + normalize on the train split (SVHN:
    normalize only, as the reference's svhn.py), normalize on the test
    split; drop-remainder batches. native_library: the path of a built
    native augment library to take (None: numpy's path)."""
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
                           train_augment=False, native_library=native_library)
    return _cifar_like(arrays, train_batch_size, eval_batch_size, seed, datasets.CIFAR10_MEAN, datasets.CIFAR10_STD,
                       native_library=native_library)
