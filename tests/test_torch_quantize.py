"""Kernel K2 (alignq_tpu_torch/kernels/quantize.py, which on the CPU runs
its plain version) against the JAX package's cdf_quantize_int8, whose
Pallas kernel runs in interpret mode on the CPU, on the same numpy inputs.

Tolerance: the codes are identical. The plain version repeats the JAX
kernel's arithmetic under jit (reciprocal multiply by 1/sqrt2, every
`a * b + c` rounded once); the port's reference, like JAX's, runs XLA's
erf of x / sqrt2 and is compared bit for bit too. The CUDA sources carry
the same constants as f32 hex literals, checked here against the Python
ones.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignq_tpu.kernels import quantize as JQ
from alignq_tpu_torch import kernels as TK
from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels import quantize as TQ
from alignq_tpu_torch.quant import cdf as tcdf

CSRC = Path(TQ.__file__).resolve().parents[1] / "csrc"
HEXFLOAT = r"(-?0x[0-9a-f.]+p[-+]?\d+)f"


def _x(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 1.5).astype(np.float32)


@pytest.mark.parametrize("shape,seed", [((130, 48), 0), ((512, 1024), 1), ((7, 33, 5), 2)])
def test_codes_match_jax_kernel(shape, seed):
    x = _x(shape, seed)
    want = np.asarray(JQ.cdf_quantize_int8(x))
    got = TQ.cdf_quantize_int8(torch.from_numpy(x))
    assert got.dtype == torch.int8 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_exported():
    assert TK.cdf_quantize_int8 is TQ.cdf_quantize_int8


@pytest.mark.parametrize("shape,seed", [((130, 48), 3), ((512, 1024), 4), ((7, 33, 5), 5)])
def test_reference_matches_jax_reference(shape, seed):
    x = _x(shape, seed)
    want = np.asarray(JQ.cdf_quantize_int8_reference(jnp.asarray(x)))
    got = TQ.cdf_quantize_int8_reference(torch.from_numpy(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_range_saturation():
    x = torch.tensor([[-100.0, 0.0, 100.0, -0.0]])
    assert TQ.cdf_quantize_int8(x).tolist() == [[-127, 0, 127, 0]]
    np.testing.assert_array_equal(np.asarray(JQ.cdf_quantize_int8(x.numpy()))[0], [-127, 0, 127, 0])


def test_grid_points_and_ties():
    """Inputs on every level of the grid and on the midpoints between
    levels, each with its two f32 neighbours. There the last bit of
    exp(-z^2) decides a code: XLA's CPU exp and torch's differ in that bit
    on ~10% of inputs (XLA's is correctly rounded on ~91%, torch's on
    ~99%), so a code may be one away. Measured: 2 of these 1530 inputs
    (+-0.6137658, codes +-59 against +-58); allowed: 4."""
    from scipy.special import erfinv

    levels = np.arange(-127, 128, 0.5) / 127.0
    x = (np.sqrt(2.0) * erfinv(np.clip(levels, -0.999999, 0.999999))).astype(np.float32)
    x = np.concatenate([x, np.nextafter(x, np.inf), np.nextafter(x, -np.inf)])[None, :]
    want = np.asarray(JQ.cdf_quantize_int8(x)).astype(np.int32)
    got = TQ.cdf_quantize_int8(torch.from_numpy(x)).numpy().astype(np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).sum() <= 4, (diff > 0).sum()


def test_rejects_other_dtypes():
    with pytest.raises(TypeError):
        TQ.cdf_quantize_int8(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        TQ.cdf_quantize_int8(torch.zeros(4).to_sparse())


def test_cpu_runs_no_kernel():
    before = dict(_build.launches)
    TQ.cdf_quantize_int8(torch.ones(8))
    assert dict(_build.launches) == before


def test_quantize_source_carries_f32_constants():
    """K2's map, csrc/act_codes.cuh as_code (which csrc/quantize.cu's direct
    kernel evaluates, with no constant of its own): 1/sqrt2, then p of A&S
    7.1.26, then a5..a1 (the Horner order), each the f32 rounding of the
    JAX kernel's constant."""
    assert re.findall(HEXFLOAT, (CSRC / "quantize.cu").read_text()) == []
    assert "act::as_code(" in (CSRC / "quantize.cu").read_text()
    body = re.search(r"int as_code\(.*?\n}\n", (CSRC / "act_codes.cuh").read_text(), re.S).group(0)
    lits = [float.fromhex(v) for v in re.findall(HEXFLOAT, body)]
    want = [float(np.float32(1 / math.sqrt(2.0))), TQ._AS_P, *TQ._AS_A[::-1]]
    assert lits == want


def test_act_header_carries_f32_erf_constants():
    """csrc/act_codes.cuh erf_code: 1/sqrt2, the clamp, XLA's P then Q
    coefficients (quant/cdf.py), each rounded to f32."""
    src = (CSRC / "act_codes.cuh").read_text()
    body = re.search(r"int erf_code\(.*?\n}\n", src, re.S).group(0)
    lits = [float.fromhex(v) for v in re.findall(HEXFLOAT, body)]
    clamp = tcdf._ERF_CLAMP
    want = [float(np.float32(1 / math.sqrt(2.0))), -clamp, clamp, *tcdf._ERF_P, *tcdf._ERF_Q]
    assert lits == want


@pytest.mark.parametrize("impl,g", [("erf", 127), ("poly", 127), ("erf", 7), ("bins", 7), ("bins", 1)])
def test_act_codes_match_erfq_codes(impl, g):
    """act_codes is the act-site map of kernels/infer.py _erfq_codes (under
    jit, as the serving graph runs it)."""
    from alignq_tpu.kernels import infer as J

    bits = {127: 8, 7: 4, 1: 2}[g]
    h = (np.random.RandomState(g).randn(1 << 13) * 2).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: J._erfq_codes(v, bits, impl))(h))
    np.testing.assert_array_equal(TQ.act_codes(torch.from_numpy(h), g, impl).numpy(), want)
