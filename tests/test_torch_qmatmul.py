"""Kernel K1's plain version (alignq_tpu_torch/kernels/qmatmul.py, which
the CPU runs) against the JAX reference under jax.jit, on the same numpy
inputs. Raw int32 accumulators are exact; the f32 epilogue
`acc * scale + bias` is one rounding on both sides, so it is bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignq_tpu.kernels.qmatmul import int8_matmul_dequant_reference as jref
from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels.qmatmul import (
    K_MULT,
    gather_taps,
    int8_matmul_dequant,
    int8_matmul_int32,
    int8_matmul_packed,
    kernel_matrix,
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
