"""The port's binding of native/augment.cpp (alignq_tpu_torch/data/
native_augment.py) against the JAX package's numpy path (alignq_tpu/data/
native_augment.py with no native/libaugment.so, as here).

The library is built with g++ into each test's own tmp_path, so that the
port's shared build directory never changes another test process's
batches. Checked:
- the same draws from the loader's RandomState (oy, ox, then flips): the
  generators' states agree after a batch either way;
- crops and flips exact: with an all-ones mean and std, both paths'
  values times 255 plus 255 round back to the same uint8 pixels;
- the normalized values at CIFAR-10's mean and std within 1e-5 absolute:
  the native map folds /255 into an f32 scale 1 / (255 std) and a shift
  -mean / std and takes one multiply-add (two roundings at most, with
  those of the folded constants), where numpy rounds three times; the
  values reach |2.8|, a few f32 ulps are ~1e-6;
- normalize_only likewise;
- the registry takes numpy's path unless its caller passes a built
  library (a library in the build directory does not switch it): equal to
  JAX's batches bit for bit without it, within 1e-5 with it; a library
  asked for and missing raises.
"""

import numpy as np
import pytest

from alignq_tpu.data import datasets as jdatasets
from alignq_tpu.data import native_augment as jnative
from alignq_tpu.data.registry import get_data as jget
from alignq_tpu_torch.data import native_augment as tnative
from alignq_tpu_torch.data.registry import get_data as tget

MEAN, STD = jdatasets.CIFAR10_MEAN, jdatasets.CIFAR10_STD


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return tnative.build(tmp_path_factory.mktemp("augment"))


def _images(n=64, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)


def test_jax_takes_numpy_here():
    assert not jnative.available()


def test_draws_crops_and_flips_equal_numpy(lib):
    x = _images()
    ones = np.ones(3, np.float32)
    r_np, r_nat = np.random.RandomState(5), np.random.RandomState(5)
    want = jnative.augment_normalize(x, r_np, ones, ones)
    got = tnative.augment_normalize(x, r_nat, ones, ones, library=lib)
    assert tnative.available(lib)
    for a, b in zip(r_np.get_state(), r_nat.get_state()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.rint((got + 1) * 255).astype(np.uint8), np.rint((want + 1) * 255).astype(np.uint8))
    # the crops and flips drew something: padding zeros and mirrored rows
    assert (np.rint((got + 1) * 255) == 0).any()


def test_normalized_values_within_the_multiply_add(lib):
    x = _images(seed=1)
    want = jnative.augment_normalize(x, np.random.RandomState(2), MEAN, STD)
    got = tnative.augment_normalize(x, np.random.RandomState(2), MEAN, STD, library=lib)
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not np.array_equal(got, want)  # the native kernel's own rounding, not numpy's
    np.testing.assert_allclose(tnative.normalize_only(x, MEAN, STD, library=lib),
                               jnative.normalize_only(x, MEAN, STD), rtol=0, atol=1e-5)


def test_registry_takes_numpy_unless_built(lib, monkeypatch):
    jd = jget("synthetic", "data", 64, 100, seed=4)
    (jx, jy), (jex, _) = next(iter(jd.loader_train)), next(iter(jd.loader_test))
    # a library in the shared build directory switches nothing: numpy's
    # batches unless the caller passes the library
    monkeypatch.setattr(tnative, "BUILD_DIR", lib.parent)
    assert tnative.available()
    td = tget("synthetic", "data", 64, 100, seed=4)
    (tx, ty) = next(iter(td.loader_train))
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    td = tget("synthetic", "data", 64, 100, seed=4, native_library=str(lib))
    (tx, ty), (ex, _) = next(iter(td.loader_train)), next(iter(td.loader_test))
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-5)
    assert not np.array_equal(tx, jx)
    np.testing.assert_allclose(ex, jex, rtol=0, atol=1e-5)


def test_a_library_asked_for_and_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no native augment library"):
        tget("synthetic", "data", 64, 100, seed=4, native_library=str(tmp_path / "libaugment.so"))
    assert not tnative.available(tmp_path / "libaugment.so")


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        tnative.build(tmp_path)


def test_the_cli_flag_takes_the_library_for_its_run_only(lib, monkeypatch):
    from alignq_tpu_torch.train.cli import parse_args

    monkeypatch.setattr(tnative, "BUILD_DIR", lib.parent)  # built there already: no compile
    *_, native_library = parse_args(["--native_augment", "--dataset", "synthetic", "--device", "cpu"])
    assert native_library == str(lib)
    *_, native_library = parse_args(["--dataset", "synthetic", "--device", "cpu"])
    assert native_library is None  # the next run without the flag: numpy's batches
