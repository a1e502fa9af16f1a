"""Shared inputs of the tests/test_torch_*.py files."""

import numpy as np
import pytest
import torch

from alignq_tpu_torch import interop


def random_preact_tree(depth, seed):
    """A flax-layout PreActResNet (params, batch_stats) of the given depth,
    every leaf drawn with numpy: fan-in-scaled uniform kernels and
    non-trivial BN scale, shift, mean and variance."""
    return random_like(interop.init_preact_resnet_params(depth, torch.Generator().manual_seed(0), "cpu"), seed)


def random_densenet_tree(depth, seed, stage_int8=False):
    """A flax-layout DenseNet (params, batch_stats), drawn as
    random_like draws; with stage_int8 the StageRequant amax too."""
    shapes = interop.init_densenet_params(depth, torch.Generator().manual_seed(0), "cpu", stage_int8=stage_int8)
    return random_like(shapes, seed)


def random_mobilenet_tree(seed):
    """A flax-layout MobileNet-V2 (params, batch_stats), drawn as
    random_like draws."""
    return random_like(interop.init_mobilenetv2_params(torch.Generator().manual_seed(0), "cpu"), seed)


def random_like(trees, seed):
    """(params, batch_stats) of the shapes of `trees`, every leaf drawn with
    numpy: fan-in-scaled uniform kernels, non-trivial BN scale, shift, mean
    and variance, StageRequant amax uniform in [2, 6]."""
    shapes, stat_shapes = trees
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
            elif k == "amax":
                out[k] = (rng.rand(*shape) * 4 + 2).astype(np.float32)
            else:  # bias, mean
                out[k] = (rng.randn(*shape) * 0.2).astype(np.float32)
        return out

    return draw(shapes), draw(stat_shapes)


def f64_tree(tree):
    """A nested dict with every floating leaf as float64 numpy."""
    if isinstance(tree, dict):
        return {k: f64_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


def flat_names(tree, prefix=""):
    """A nested dict -> {'a.b.c': numpy leaf}, the port's parameter names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_names(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def to_port_layout(name, a):
    """A flax leaf in the port's layout: conv kernels HWIO -> OIHW."""
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if name.endswith("kernel") and a.ndim == 4 else a


def write_tiny_cifar10(data_dir, per_batch=16, n_test=64, seed=0):
    """CIFAR-10's python pickles (five train batches and a test batch) of
    a few seeded random images under data_dir/cifar-10-batches-py, so that
    a loader or a trainer runs on the cifar10 path in a second."""
    import os
    import pickle

    base = os.path.join(str(data_dir), "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name in names:
        n = n_test if name == "test_batch" else per_batch
        d = {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8), b"labels": list(rng.randint(0, 10, n))}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(d, f)
    return str(data_dir)


@pytest.fixture
def one_torch_thread():
    """torch on one intra-op thread for the test, restored after: the
    suite runs several test processes at once, and eager PyTorch on small
    tensors gains nothing from threads that then contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
