"""The table form of the act-code map (kernels/quantize.py act_table, the
map csrc/act_codes.cuh table_code evaluates on the card) on the CPU.

The erf and poly maps code(h) = clip(rint(c(h) * g), +-g) are step
functions of the f32 h; the table holds each step's threshold in a bucket
of h (at most one a bucket) and, where the f32 map is not monotone, the
few-ulp window in which the map's own code is taken. Here, for both maps
at each grid a served graph uses (A8's 127, A4's 7) and A2's 1, relu'd and
not:
- the table map equals the direct plain map (act_codes) on every f32 within
  +-65,536 ulps of every step, and on 10M seeded random f32 (half normal,
  half uniform bit patterns);
- it equals jitted JAX's `_erfq_codes` on a seeded sample;
- the table's layout: one step a bucket at most, the windows few and
  narrow, the code ranges the relu and the grid give.
chip_smoke.py checks the same map on the card over all 2^32 bit patterns.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from alignq_tpu.kernels import infer as JI
from alignq_tpu_torch.kernels import quantize as Q

CPU = torch.device("cpu")
GRIDS = [("erf", 127), ("poly", 127), ("erf", 7), ("poly", 7), ("erf", 1), ("poly", 1)]


def _direct(h: np.ndarray, impl: str, g: int) -> np.ndarray:
    return Q.act_codes(torch.from_numpy(h), g, impl).numpy()


def _table(h: np.ndarray, impl: str, g: int, relu: bool) -> np.ndarray:
    return Q.act_codes_table_plain(torch.from_numpy(h), Q.act_table(impl, g, CPU, relu)).numpy()


def _check(h: np.ndarray, impl: str, g: int) -> None:
    direct = _direct(h, impl, g)
    np.testing.assert_array_equal(_table(h, impl, g, False), direct)
    np.testing.assert_array_equal(_table(h, impl, g, True), np.maximum(direct, 0))


@pytest.mark.parametrize("impl,g", GRIDS)
def test_table_equals_the_map_around_every_step(impl, g):
    wa, _ = Q.act_table_steps(impl, g)
    keys = Q._f32_key(wa)
    span = np.arange(-65536, 65537)
    for first in range(0, len(keys), 32):  # 32 steps at a time: 4M values
        h = Q._f32_of_key((keys[first:first + 32, None] + span[None, :]).ravel())
        _check(h, impl, g)


@pytest.mark.parametrize("impl,g", GRIDS[:4])
def test_table_equals_the_map_on_random_f32(impl, g):
    rng = np.random.default_rng(g * 10 + len(impl))
    bits = rng.integers(-(2**31), 2**31, 5_000_000, dtype=np.int64).astype(np.int32).view(np.float32)
    h = np.concatenate([(rng.standard_normal(5_000_000) * 2).astype(np.float32), bits[~np.isnan(bits)]])
    _check(h, impl, g)


@functools.lru_cache(maxsize=None)
def _jax_codes(bits, impl):
    return jax.jit(lambda h: JI._erfq_codes(h, bits, impl))


@pytest.mark.parametrize("impl,bits", [("erf", 8), ("poly", 8), ("erf", 4), ("poly", 4)])
def test_table_equals_jitted_jax(impl, bits):
    g = {8: 127, 4: 7}[bits]
    h = (np.random.RandomState(bits).randn(1 << 20) * 1.5).astype(np.float32)
    want = np.asarray(_jax_codes(bits, impl)(h))
    np.testing.assert_array_equal(_table(h, impl, g, False), want)
    np.testing.assert_array_equal(_table(h, impl, g, True), np.maximum(want, 0))


@pytest.mark.parametrize("impl,g", GRIDS)
@pytest.mark.parametrize("relu", [True, False])
def test_table_layout(impl, g, relu):
    t = Q.act_table(impl, g, CPU, relu)
    e = t.entries.numpy()
    assert e.dtype == np.int32 and e.shape[1] == 2 and 1 <= len(e) <= 1024
    base = (e[:, 0] & 0xFFFF) - g
    w = e[:, 0] >> 16
    assert base.min() >= (0 if relu else -g) and base.max() <= g - 1
    steps = np.isfinite(e[:, 1].view(np.float32))
    assert steps.sum() >= (g if relu else 2 * g) and (w[~steps] == 0).all()
    assert (w < 200).all() and (w > 0).sum() <= 40  # a few windows of a few ulps
    assert t.lo == (Q.act_table_steps(impl, g)[0][g] if relu else Q.act_table_steps(impl, g)[0][0])
    assert Q.act_table_bucket(np.float32([t.lo]))[0] == t.b_lo


def test_table_refuses_other_maps():
    with pytest.raises(ValueError, match="erf or poly"):
        Q.act_table("bins", 7, CPU)
