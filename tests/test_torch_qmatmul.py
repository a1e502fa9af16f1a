"""Kernel K1's plain version (alignq_tpu_torch/kernels/qmatmul.py, which
the CPU runs) against the JAX reference under jax.jit, on the same numpy
inputs. Raw int32 accumulators are exact; the f32 epilogue
`acc * scale + bias` is one rounding on both sides, so it is bit-identical.
So are the act codes of the codes epilogue (int8_matmul_codes), against
the JAX graph's act-site maps `_erfq_codes` of that epilogue and
`_int_bin_codes` of the accumulator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignq_tpu.kernels import infer as J
from alignq_tpu.kernels.qmatmul import int8_matmul_dequant_reference as jref
from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels import infer as T
from alignq_tpu_torch.kernels.convert import QConvInt8 as TQConv
from alignq_tpu_torch.kernels.qmatmul import (
    K_MULT,
    act_map,
    gather_taps,
    int8_matmul_codes,
    int8_matmul_dequant,
    int8_matmul_int32,
    int8_matmul_packed,
    kernel_matrix,
    pack_act_cutpoints,
    pack_k1_weights,
)

SHAPES = [(100, 70, 50), (1000, 27, 16), (333, 144, 32), (64, 16, 32), (128, 576, 64), (40, 288, 128)]


def _operands(m, k, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    s = (rng.rand(n) * 1e-3).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    return x, w, s, b


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int32_exact(m, k, n):
    x, w, _, _ = _operands(m, k, n)
    want = jax.jit(
        lambda a, b: jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    )(x, w)
    got = int8_matmul_int32(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_dequant_bit_identical(m, k, n, relu):
    x, w, s, b = _operands(m, k, n, seed=1)
    want = jax.jit(lambda *a: jref(*a, relu=relu))(x, w, s, b)
    got = int8_matmul_dequant(*(torch.from_numpy(a) for a in (x, w, s, b)), relu=relu)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dequant_no_bias():
    x, w, s, _ = _operands(50, 32, 24, seed=2)
    want = jax.jit(jref)(x, w, s)
    got = int8_matmul_dequant(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", [(100, 70, 50), (64, 16, 32), (40, 288, 128)])
@pytest.mark.parametrize("mode", ["int32", "f32", "relu"])
def test_packed_matches_jax(m, k, n, mode):
    """A weight packed once (K and N zero-padded, W^T) gives JAX's result;
    x may keep its unpadded K."""
    x, w, s, b = _operands(m, k, n, seed=3)
    op = pack_k1_weights(*(torch.from_numpy(a) for a in (w, s, b)))
    assert op.wt.shape == ((n + 7) // 8 * 8, (k + K_MULT - 1) // K_MULT * K_MULT)
    got = int8_matmul_packed(torch.from_numpy(x), op, mode)
    if mode == "int32":
        want = jax.jit(lambda a, c: jnp.matmul(a, c, preferred_element_type=jnp.int32))(x, w)
    else:
        want = jax.jit(lambda *a: jref(*a, relu=mode == "relu"))(x, w, s, b)
    assert got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_packed_rejects_deeper_x():
    op = pack_k1_weights(torch.zeros((16, 8), dtype=torch.int8))
    with pytest.raises(ValueError):
        int8_matmul_packed(torch.zeros((4, 40), dtype=torch.int8), op)


def test_cpu_runs_no_kernel():
    x, w, s, b = _operands(8, 8, 8)
    before = dict(_build.launches)
    int8_matmul_dequant(*(torch.from_numpy(a) for a in (x, w, s, b)))
    assert dict(_build.launches) == before


@pytest.mark.parametrize(
    "ksize,stride,padding,cin", [(3, 1, 1, 3), (3, 2, 1, 16), (1, 2, 0, 16), (1, 1, 0, 32), (3, 1, 1, 64)]
)
def test_gathered_taps_conv_exact(ksize, stride, padding, cin):
    """The conv as K1 over gathered taps (K zero-padded to the MMA depth)
    gives XLA's int8 conv accumulators exactly."""
    rng = np.random.RandomState(ksize + stride + cin)
    x = rng.randint(-127, 128, (2, 8, 8, cin)).astype(np.int8)
    kern = rng.randint(-127, 128, (ksize, ksize, cin, 16)).astype(np.int8)
    want = jax.jit(
        lambda a, k: jax.lax.conv_general_dilated(
            a, k, (stride, stride), [(padding, padding)] * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32,
        )
    )(x, kern)
    cols = gather_taps(torch.from_numpy(x), ksize, stride, padding, K_MULT)
    kmat = kernel_matrix(torch.from_numpy(kern), K_MULT)
    assert cols.shape[1] % K_MULT == 0 and kmat.shape[0] == cols.shape[1]
    got = int8_matmul_int32(cols, kmat).reshape(np.shape(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CODE_SHAPES = [(100, 70, 50), (333, 144, 32), (64, 16, 20), (40, 288, 128)]


def _code_operands(m, k, n, seed):
    """Operands whose epilogue h spreads over the act grid (|h| up to ~4),
    with some negative scales, as folded BN gives."""
    x, w, _, _ = _operands(m, k, n, seed)
    rng = np.random.RandomState(seed + 100)
    s = (rng.rand(n) * 2 - 0.4) * 2 / (np.sqrt(k) * 73.3**2)
    b = rng.randn(n) * 0.5
    return x, w, s.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("m,k,n", CODE_SHAPES)
@pytest.mark.parametrize("impl,bits", [("poly", 8), ("erf", 8), ("bins", 4)])
def test_codes_match_jax(m, k, n, impl, bits):
    x, w, s, b = _code_operands(m, k, n, seed=5)
    want = jax.jit(lambda *a: J._erfq_codes(jref(*a), bits, impl))(x, w, s, b)
    op = pack_k1_weights(*(torch.from_numpy(a) for a in (w, s, b)))
    got = int8_matmul_codes(torch.from_numpy(x), op, act_map(impl, 2 ** (bits - 1) - 1, torch.device("cpu")))
    assert got.dtype == torch.int8 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", CODE_SHAPES)
def test_bins_int_codes_match_jax(m, k, n):
    x, w, s, b = _code_operands(m, k, n, seed=6)
    s[:2] = [0.0, -abs(s[2])]  # a degenerate channel and a negative scale
    cut = T.act_int_cutpoints(TQConv(torch.zeros((1, 1, k, n), dtype=torch.int8), *map(torch.from_numpy, (s, b))), 4)
    acc = jax.jit(lambda a, c: jnp.matmul(a, c, preferred_element_type=jnp.int32))(x, w)
    want = jax.jit(J._int_bin_codes)(acc, {key: jnp.asarray(v.numpy()) for key, v in cut.items()})
    op = pack_k1_weights(*(torch.from_numpy(a) for a in (w, s, b)))
    act = pack_act_cutpoints(cut, op.wt.shape[0])
    assert act.g == 7 and act.t1.shape == (7, op.wt.shape[0])
    got = int8_matmul_codes(torch.from_numpy(x), op, act)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_act_map_guards():
    with pytest.raises(ValueError):
        act_map("bins", 127, torch.device("cpu"))
    with pytest.raises(ValueError):
        act_map("bins_int", 7, torch.device("cpu"))  # per site: pack_act_cutpoints
    bins = act_map("bins", 7, torch.device("cpu"))
    assert bins.bnd.dtype == torch.float32 and bins.bnd.shape == (7,)
    assert act_map("bins", 7, torch.device("cpu")) is bins  # laid out once


def test_codes_cpu_runs_no_kernel():
    x, w, s, b = _code_operands(8, 8, 8, seed=7)
    before = dict(_build.launches)
    op = pack_k1_weights(*(torch.from_numpy(a) for a in (w, s, b)))
    int8_matmul_codes(torch.from_numpy(x), op, act_map("erf", 127, torch.device("cpu")))
    assert dict(_build.launches) == before
