"""Office-31 domain-adaptation data (port of alignq_tpu/data/office.py):
ImageFolder trees read with PIL where they exist, an 80/20 index split
seeded 1, and, with no images on disk, a two-domain synthetic set (class
templates shared by the domains, a per-domain colour and contrast shift).
Batches equal the JAX package's array for array."""

from __future__ import annotations

import os
import zlib
from typing import Optional, Tuple

import numpy as np

from alignq_tpu_torch.data.datasets import synthetic
from alignq_tpu_torch.data.loader import ArrayLoader

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def split_train_test(n: int, train_frac: float = 0.8, seed: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """A seeded permutation of n indices cut at train_frac."""
    idx = np.random.RandomState(seed).permutation(n)
    k = int(n * train_frac)
    return idx[:k], idx[k:]


def load_image_folder(root: str, image_size: int = 224) -> Optional[tuple]:
    """An ImageFolder tree (a subdirectory of images a class, classes
    sorted) as (uint8 NHWC resized to image_size, int32 labels); None where
    the tree, PIL or any readable image is absent."""
    if not os.path.isdir(root):
        return None
    try:
        from PIL import Image
    except ImportError:
        return None
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    xs, ys = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for fname in sorted(os.listdir(cdir)):
            try:
                img = Image.open(os.path.join(cdir, fname)).convert("RGB")
            except Exception:
                continue
            xs.append(np.asarray(img.resize((image_size, image_size)), np.uint8))
            ys.append(ci)
    if not xs:
        return None
    return np.stack(xs), np.asarray(ys, np.int32)


def synthetic_domain(domain: str, n: int, num_classes: int = 31, image_size: int = 64, seed: int = 0):
    """The synthetic set's images with the domain's gain and bias, seeded
    by the crc32 of its name (the same pixels in every process)."""
    x, y, _, _ = synthetic(n_train=n, n_test=1, shape=(image_size, image_size, 3), num_classes=num_classes, seed=seed)
    rng = np.random.RandomState(zlib.crc32(domain.encode()) % (2**31))
    gain = rng.uniform(0.6, 1.4, (1, 1, 1, 3)).astype(np.float32)
    bias = rng.uniform(-30, 30, (1, 1, 1, 3)).astype(np.float32)
    return np.clip(x.astype(np.float32) * gain + bias, 0, 255).astype(np.uint8), y


def get_office_domain(data_dir: str, domain: str, batch_size: int, *, train: bool, train_split: float = 0.8,
                      seed: int = 1, image_size: int = 224, num_classes: int = 31) -> ArrayLoader:
    """One domain's loader ('amazon' | 'dslr' | 'webcam'): its train or
    test split, ImageNet-normalized; 1024 synthetic images of at most 64x64
    where data_dir/office31/<domain>/images is absent."""
    loaded = load_image_folder(os.path.join(data_dir, "office31", domain, "images"), image_size)
    x, y = synthetic_domain(domain, 1024, num_classes, min(image_size, 64), seed) if loaded is None else loaded
    tr_idx, te_idx = split_train_test(len(x), train_split, seed)
    idx = tr_idx if train else te_idx

    def norm(b):
        return (b.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD

    return ArrayLoader(x[idx], y[idx], batch_size, shuffle=train, drop_remainder=True, transform_fn=norm, seed=seed)


def get_office_pair(data_dir: str, src: str, tgt: str, batch_size: int, eval_batch_size: int, seed: int = 1,
                    image_size: int = 224) -> dict:
    """{'src_train', 'tgt_train', 'src_test', 'tgt_test'} loaders of two
    domains."""
    def dom(name, bs, train):
        return get_office_domain(data_dir, name, bs, train=train, seed=seed, image_size=image_size)

    return {"src_train": dom(src, batch_size, True), "tgt_train": dom(tgt, batch_size, True),
            "src_test": dom(src, eval_batch_size, False), "tgt_test": dom(tgt, eval_batch_size, False)}
