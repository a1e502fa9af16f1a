"""Batch loaders with deterministic shuffling and background prefetch
(port of alignq_tpu/data/loader.py). Drop-remainder batches keep shapes
static, which the ADMM B x B duals need; each epoch's shuffle is seeded by
(seed, epoch), so a resumed run sees the same batches.

A consumer that feeds a CUDA card sets `pin_memory`: the prefetch worker
then hands out each batch as CPU tensors in pinned memory (the same
values), and `to_tensor` copies them to the card without blocking the
host."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch


def to_tensor(x, dev: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A numpy array or CPU tensor on `dev` (a floating one in `dtype`,
    where given); a copy from pinned memory does not block the host."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    t = t.to(dev, non_blocking=t.is_pinned())
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


class ArrayLoader:
    """Iterate (images, labels) minibatches over in-memory arrays."""

    def __init__(
        self,
        x: np.ndarray,
        y: np.ndarray,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_remainder: bool = True,
        augment_fn: Optional[Callable[[np.ndarray, np.random.RandomState], np.ndarray]] = None,
        transform_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        seed: int = 0,
        prefetch: int = 2,
    ):
        if len(x) != len(y):
            raise ValueError(f"{len(x)} images but {len(y)} labels")
        self.x, self.y = x, y
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.augment_fn = augment_fn
        self.transform_fn = transform_fn
        self.seed = seed
        self.prefetch = prefetch
        self.pin_memory = False
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.x)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.x)
        rng = np.random.RandomState((self.seed, self.epoch))
        idx = rng.permutation(n) if self.shuffle else np.arange(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_remainder else n
        for i in range(0, stop, self.batch_size):
            take = idx[i : i + self.batch_size]
            xb, yb = self.x[take], self.y[take]
            if self.augment_fn is not None:
                xb = self.augment_fn(xb, rng)
            if self.transform_fn is not None:
                xb = self.transform_fn(xb)
            if self.pin_memory:
                xb = torch.from_numpy(np.ascontiguousarray(xb)).pin_memory()
                yb = torch.from_numpy(np.ascontiguousarray(yb)).pin_memory()
            yield xb, yb

    def __iter__(self):
        self.epoch += 1
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def worker():
            try:
                for b in self._batches():
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is sentinel:
                    break
                yield b
        finally:
            # a consumer that stops early (max_steps) releases the worker
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()


class Data:
    """loader_train / loader_test pair."""

    def __init__(self, loader_train: ArrayLoader, loader_test: ArrayLoader):
        self.loader_train = loader_train
        self.loader_test = loader_test
