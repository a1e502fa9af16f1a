"""alignq_tpu_torch quant/cdf.py and kernels/convert.py against the JAX
package under jax.jit, on the same numpy inputs (CPU).

Tolerances. erf (the port's erf_f32 is XLA's approximation), the poly
grid and the CDF built on them are bit-identical. f32 reductions are
summed in another order than XLA's, so the statistics and the folded
scale/bias agree to a few ulps (rtol 1e-6; the pdf, through two
implementations of exp, 1e-5). Weight codes are CDF codes of those
statistics: they agree but where a statistic's last bit moves an element
across a rounding boundary, at most 1 code on at most 1e-4 of elements.
The JAX package is no tighter with itself: its eager and jitted converters
differ on 4 of 884,736 such codes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignq_tpu.kernels import convert as jconv
from alignq_tpu.kernels import infer as jinfer
from alignq_tpu.quant import cdf as jcdf
from alignq_tpu_torch import interop
from alignq_tpu_torch.kernels import convert as tconv
from alignq_tpu_torch.kernels import infer as tinfer
from alignq_tpu_torch.quant import cdf as tcdf
from torch_port_helpers import random_preact_tree


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.fixture
def z():
    return (np.random.RandomState(0).randn(1 << 14) * 2.0).astype(np.float32)


def test_poly_coefficients_shared():
    assert tcdf.ERF_SQRT2_POLY == jcdf.ERF_SQRT2_POLY


def test_erf_sqrt2_poly_bit_identical(z):
    want = np.asarray(jax.jit(lambda v: jcdf.erf_sqrt2(v, "poly"))(z))
    np.testing.assert_array_equal(_np(tcdf.erf_sqrt2(_t(z), "poly")), want)


def test_erf_f32_bit_identical():
    x = np.concatenate([np.linspace(-6, 6, 120001, dtype=np.float32), _h_wide()])
    want = np.asarray(jax.jit(jax.lax.erf)(x))
    np.testing.assert_array_equal(_np(tcdf.erf_f32(_t(x))), want)


def _h_wide():
    return (np.random.RandomState(9).randn(1 << 16) * 2).astype(np.float32)


def test_erf_sqrt2_erf_bit_identical(z):
    want = np.asarray(jax.jit(lambda v: jcdf.erf_sqrt2(v, "erf"))(z))
    np.testing.assert_array_equal(_np(tcdf.erf_sqrt2(_t(z), "erf")), want)


def test_erf_sqrt2_unknown_impl():
    with pytest.raises(ValueError):
        tcdf.erf_sqrt2(torch.zeros(3), "spline")


@pytest.mark.parametrize("g", [1, 3, 7, 15, 127])
def test_erf_grid_boundaries_equal(g):
    np.testing.assert_array_equal(tcdf.erf_grid_boundaries(g), jcdf.erf_grid_boundaries(g))


def test_fma_f32_rounds_once():
    # 1 + 2^-24 is an f32 midpoint: two roundings give 1.0, one gives 1 + 2^-23
    a = torch.tensor([1.0 + 2.0**-23], dtype=torch.float32)
    got = tcdf.fma_f32(a, a, torch.tensor([-1.0]))
    assert got.dtype == torch.float32
    assert got.item() == np.float32((1.0 + 2.0**-23) ** 2 - 1.0)


@pytest.mark.parametrize("impl", ["erf", "poly"])
def test_gaussian_cdf_and_pdf(z, impl):
    mean, std = np.float32(0.3), np.float32(1.7)
    # mean/std as arguments, as the computed statistics they are in use: a
    # compile-time constant divisor would become a reciprocal multiply
    want = np.asarray(jax.jit(lambda v, m, s: jcdf.gaussian_cdf(v, m, s, impl))(z, mean, std))
    got = _np(tcdf.gaussian_cdf(_t(z), _t(mean), _t(std), impl))
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jax.jit(jcdf.gaussian_pdf2)(z, mean, std))
    np.testing.assert_allclose(_np(tcdf.gaussian_pdf2(_t(z), _t(mean), _t(std))), want, rtol=1e-5)


def test_stats():
    w = np.random.RandomState(1).randn(3, 3, 16, 32).astype(np.float32) * 0.1
    for tf, jf in ((tcdf.tensor_stats, jcdf.tensor_stats), (tcdf.channel_stats, jcdf.channel_stats)):
        for got, want in zip(tf(_t(w)), jax.jit(jf)(w)):
            assert tuple(got.shape) == np.shape(want)
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)


def assert_codes_close(pairs):
    """At most 1 code apart, on at most 1e-4 of the elements of all pairs
    (the rate measured over 884,736 codes is ~6e-6; one tensor of this
    file holds ~0.2 such elements on average)."""
    diffs = [np.abs(_np(g).astype(np.int32) - np.asarray(w).astype(np.int32)).ravel() for g, w in pairs]
    diff = np.concatenate(diffs)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, (diff.max(), (diff > 0).sum())


def test_grid_constants():
    assert tconv.W_SCALE == jconv.W_SCALE
    for bits in (2, 4, 8):
        assert tconv.grid_max(bits) == jconv.grid_max(bits)


@pytest.mark.parametrize("bits,channelwise", [(8, False), (4, False), (8, True), (2, False)])
def test_weight_codes(bits, channelwise):
    w = np.random.RandomState(bits).randn(3, 3, 64, 64).astype(np.float32) * 0.05
    want = np.asarray(jax.jit(lambda v: jconv.quantize_weight_int8(v, bits, channelwise))(w))
    got = tconv.quantize_weight_int8(_t(w), bits, channelwise)
    assert got.dtype == torch.int8
    assert_codes_close([(got, want)])


@pytest.mark.parametrize("bits", [8, 4])
def test_fold_conv_bn(bits):
    rng = np.random.RandomState(3)
    k = rng.randn(3, 3, 16, 32).astype(np.float32) * 0.1
    gamma, beta = rng.rand(32).astype(np.float32) + 0.5, rng.randn(32).astype(np.float32)
    mu, var = rng.randn(32).astype(np.float32) * 0.2, rng.rand(32).astype(np.float32) + 0.1
    want = jax.jit(lambda *a: jconv.fold_conv_bn(*a, act_scale=2.0 / 127, bits=bits))(k, gamma, beta, mu, var)
    got = tconv.fold_conv_bn(_t(k), _t(gamma), _t(beta), _t(mu), _t(var), act_scale=2.0 / 127, bits=bits)
    assert_codes_close([(got.kernel_int8, want.kernel_int8)])
    assert got.scale.dtype == torch.float32 and got.bias.dtype == torch.float32
    np.testing.assert_allclose(_np(got.scale), np.asarray(want.scale), rtol=1e-6)
    np.testing.assert_allclose(_np(got.bias), np.asarray(want.bias), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("wbits,abits", [(8, 8), (4, 4)])
def test_convert_preact_resnet(wbits, abits):
    params, stats = random_preact_tree(14, seed=wbits)
    want = jinfer.convert_preact_resnet(params, stats, weight_bits=wbits, act_bits=abits)
    pt, st = interop.params_from_numpy(params, stats, "cpu")
    got = tinfer.convert_preact_resnet(pt, st, weight_bits=wbits, act_bits=abits)
    pairs = [(got["conv0"], want["conv0"])]
    assert len(got["layers"]) == len(want["layers"]) == 6
    for gb, wb in zip(got["layers"], want["layers"]):
        assert gb["m"] == wb["m"] and gb["in_scale"] == wb["in_scale"]
        assert set(gb) == set(wb)
        pairs += [(gb[k], wb[k]) for k in ("conv0", "conv1", "skip") if k in wb]
    assert_codes_close([(g.kernel_int8, w.kernel_int8) for g, w in pairs])
    for g, w in pairs:
        np.testing.assert_allclose(_np(g.scale), np.asarray(w.scale), rtol=1e-6)
        np.testing.assert_allclose(_np(g.bias), np.asarray(w.bias), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(_np(got["logit"]["kernel"]), params["logit"]["kernel"])


def test_init_tree_matches_flax_init():
    from alignq_tpu.models import resnet20_quant

    v = resnet20_quant(bitW=8, abitW=8, method="ours").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False
    )
    params, stats = interop.init_preact_resnet_params(20, torch.Generator().manual_seed(0), "cpu")
    for mine, theirs in ((params, v["params"]), (stats, v["batch_stats"])):
        got = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(_np, mine))[0]}
        want = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in jax.tree_util.tree_flatten_with_path(theirs)[0]}
        assert got == want
    k = _np(params["layers_4"]["conv0"]["kernel"])
    assert np.abs(k).max() <= 1.0 / np.sqrt(9 * 32) and k.std() > 0.5 / np.sqrt(9 * 32 * 3)
    assert np.all(_np(stats["layers_4"]["bn0"]["var"]) == 1.0)
