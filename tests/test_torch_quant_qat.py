"""The port's QAT quantizers (alignq_tpu_torch/quant/{ste,fake_quant,cdf})
against the JAX package's, values and gradients, at f32 and f64.

Both sides run eagerly on the same seeded numpy inputs; gradients are
vector-Jacobian products with the same seeded cotangent. Tolerances:
- f64: values and gradients within 1e-12 (the two sides differ only in
  the order of a mean/std reduction and in erf's last ulp);
- f32: continuous values within rtol 1e-5 / atol 1e-6, gradients within
  rtol 1e-4 / atol 1e-6; rounded values equal, but for at most 1e-3 of the
  elements, each one grid step away (an f32 ulp moves a value across a
  rounding boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignq_tpu.quant import cdf as jcdf
from alignq_tpu.quant import fake_quant as jfq
from alignq_tpu.quant import ste as jste
from alignq_tpu_torch.quant import cdf as tcdf
from alignq_tpu_torch.quant import fake_quant as tfq
from alignq_tpu_torch.quant import ste as tste

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}


def _vjp_both(jf, tf, x, dtype, seed=0):
    """(jax value, jax grad, port value, port grad) of f at x under one
    seeded cotangent; the JAX side under x64 where dtype is f64."""
    npd, td = DTYPES[dtype]
    x = np.asarray(x, npd)
    with jax.enable_x64(dtype == "f64"):
        jy, jvjp = jax.vjp(jf, jnp.asarray(x))
        g = np.random.RandomState(seed).randn(*np.shape(jy)).astype(npd)
        (jg,) = jvjp(jnp.asarray(g))
        jy, jg = np.asarray(jy), np.asarray(jg)
    xt = torch.tensor(x, dtype=td, requires_grad=True)
    ty = tf(xt)
    (tg,) = torch.autograd.grad(ty, xt, torch.tensor(g, dtype=td))
    assert ty.dtype == td and tg.dtype == td
    return jy, jg, ty.detach().numpy(), tg.numpy()


def _close(got, want, dtype, rtol=1e-5, atol=1e-6):
    if dtype == "f64":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _rounded_close(got, want, dtype, step):
    """Rounded values: equal at f64; at f32 equal but for <= 1e-3 of the
    elements, each one grid step (`step`) away."""
    if dtype == "f64":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        return
    diff = np.abs(got - want)
    off = diff > 1e-6
    assert off.mean() <= 1e-3, f"{off.sum()} of {off.size} rounded values differ"
    assert np.all(diff[off] <= step * (1 + 1e-5) + 1e-6)


def _x(seed, shape=(6, 5, 4, 3), scale=1.0):
    return np.random.RandomState(seed).randn(*shape) * scale


@pytest.mark.parametrize("dtype", DTYPES)
def test_round_and_sign_ste(dtype):
    x = _x(1, scale=3.0)
    x.flat[:4] = [0.5, 1.5, -2.5, 0.0]  # half-to-even ties and sign(0)
    for jf, tf in ((jste.round_ste, tste.round_ste), (jste.sign_ste, tste.sign_ste)):
        jy, jg, ty, tg = _vjp_both(jf, tf, x, dtype)
        np.testing.assert_array_equal(ty, jy)
        np.testing.assert_array_equal(tg, jg)  # straight through: the cotangent itself


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n", [(32, None), (1, None), (2, None), (4, None), (8, None), (8, 127)])
def test_uniform_quantize(dtype, k, n):
    x = _x(2, scale=0.6)
    jy, jg, ty, tg = _vjp_both(lambda v: jste.uniform_quantize(v, k, n), lambda v: tste.uniform_quantize(v, k, n),
                               x, dtype)
    # the same inputs and the reciprocal multiply on both sides: exact
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tg, jg)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,g,signed", [(1, 127, False), (2, 127, False), (3, 127, False), (2, 7, False),
                                        (2, 127, True)])
def test_requant_grid_ste(dtype, m, g, signed):
    """On a stream of act-grid values K * act_scale (exact even-m ties
    included), beyond the saturation bound too, the values are exact and
    the gradient is the cotangent inside [lo, g*m*act_scale], 0 beyond."""
    act_scale = 2.0 / g
    k = np.random.RandomState(3).randint(-g * m - 20 if signed else 0, g * m + 20, (7, 6, 5))
    x = k * act_scale
    jy, jg, ty, tg = _vjp_both(lambda v: jste.requant_grid_ste(v, act_scale, m, g, signed),
                               lambda v: tste.requant_grid_ste(v, act_scale, m, g, signed), x, dtype)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tg, jg)
    assert (tg == 0).any() and (tg != 0).any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_requant_ste_and_its_clip_ties(dtype):
    """The clip is differentiated as jnp.clip is: 1 inside, 0 outside and
    1/2 where x equals a bound exactly. The port follows JAX's 1/2
    (torch.clamp would give 1)."""
    scale, g = 3.0 / 127.0, 127
    x = _x(4, scale=1.5)
    lim = float(np.asarray(g * scale, DTYPES[dtype][0]))
    x.flat[:4] = [lim, -lim, 4.0, -4.0]
    jy, jg, ty, tg = _vjp_both(lambda v: jste.requant_ste(v, scale, g), lambda v: tste.requant_ste(v, scale, g),
                               x, dtype)
    _rounded_close(ty, jy, dtype, scale)
    np.testing.assert_array_equal(tg, jg)
    cot = np.random.RandomState(0).randn(*x.shape).astype(DTYPES[dtype][0]).flat
    np.testing.assert_allclose(tg.flat[:4], [cot[0] / 2, cot[1] / 2, 0.0, 0.0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", ["erf", "poly"])
def test_erf_sqrt2_and_gaussian_cdf(dtype, impl):
    """Values and gradients of the act-site map and of Phi; |z| beyond
    erf_f32's clamp (3.74 * sqrt2) still gets erf's analytic gradient."""
    z = _x(5, (4096,), scale=2.0)
    z[:4] = [6.0, -6.0, 3.0, -3.0]
    jy, jg, ty, tg = _vjp_both(lambda v: jcdf.erf_sqrt2(v, impl), lambda v: tcdf.erf_sqrt2(v, impl), z, dtype)
    _close(ty, jy, dtype)
    _close(tg, jg, dtype, rtol=1e-4)
    if impl == "erf":
        assert np.all(tg[:2] != 0)
    jy, jg, ty, tg = _vjp_both(lambda v: jcdf.gaussian_cdf(v, 0.3, 1.7, impl),
                               lambda v: tcdf.gaussian_cdf(v, 0.3, 1.7, impl), z, dtype)
    _close(ty, jy, dtype)
    _close(tg, jg, dtype, rtol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_erf_f32_bits_with_autograd(dtype):
    """At f32 the differentiable erf returns erf_f32's bits (XLA's erf),
    and its gradient is 2/sqrt(pi) * exp(-x^2)."""
    x = torch.tensor(_x(6, (1000,), 2.0), dtype=DTYPES[dtype][1], requires_grad=True)
    y = tcdf.erf(x)
    if dtype == "f32":
        assert torch.equal(y, tcdf.erf_f32(x.detach()))
    (g,) = torch.autograd.grad(y.sum(), x)
    want = 2.0 / np.sqrt(np.pi) * np.exp(-(x.detach().double().numpy() ** 2))
    np.testing.assert_allclose(g.double().numpy(), want, rtol=1e-6 if dtype == "f32" else 1e-14, atol=1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["a", "b", "int8"])
@pytest.mark.parametrize("w_bit", [2, 4, 8])
def test_quantize_weight(dtype, variant, w_bit):
    w = _x(7, (3, 3, 8, 16), scale=0.1)
    jy, jg, ty, tg = _vjp_both(lambda v: jfq.quantize_weight(v, w_bit, variant=variant).wq,
                               lambda v: tfq.quantize_weight(v, w_bit, variant=variant).wq, w, dtype)
    step = (2.0 if variant == "a" else 1.0) / (2 ** (w_bit - 1) - 1 if variant == "int8" else 2**w_bit - 1)
    _rounded_close(ty, jy, dtype, step)
    _close(tg, jg, dtype, rtol=1e-4)
    for field in ("cdf", "pdf"):
        with jax.enable_x64(dtype == "f64"):
            want = np.asarray(getattr(jfq.quantize_weight(jnp.asarray(w.astype(DTYPES[dtype][0])), w_bit,
                                                          variant=variant), field))
        got = getattr(tfq.quantize_weight(torch.tensor(w, dtype=DTYPES[dtype][1]), w_bit, variant=variant), field)
        _close(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_weight_channelwise(dtype):
    """Per-output-channel statistics: the JAX package reduces an HWIO
    kernel over all but its last axis, the port an OIHW one over all but
    its first; the same kernel and cotangent give the same numbers."""
    npd, td = DTYPES[dtype]
    w = (_x(8, (3, 3, 8, 16), scale=0.1) * np.linspace(0.5, 2.0, 16)).astype(npd)
    g = np.random.RandomState(11).randn(*w.shape).astype(npd)
    to_oihw = (3, 2, 0, 1)
    with jax.enable_x64(dtype == "f64"):
        jy, vjp = jax.vjp(lambda v: jfq.quantize_weight(v, 4, channelwise=True).wq, jnp.asarray(w))
        jg = np.asarray(vjp(jnp.asarray(g))[0])
        jy = np.asarray(jy)
    xt = torch.tensor(w.transpose(to_oihw), requires_grad=True)
    ty = tfq.quantize_weight(xt, 4, channelwise=True, channel_axis=0).wq
    (tg,) = torch.autograd.grad(ty, xt, torch.tensor(g.transpose(to_oihw)))
    _rounded_close(ty.detach().numpy(), jy.transpose(to_oihw), dtype, 1.0 / 15)
    _close(tg.numpy(), jg.transpose(to_oihw), dtype, rtol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["a", "b", "int8"])
@pytest.mark.parametrize("impl", ["erf", "poly"])
@pytest.mark.parametrize("a_bit", [4, 8, 32])
def test_quantize_act_and_act_cdf(dtype, variant, impl, a_bit):
    a = _x(9, (8, 4, 6, 6), scale=1.3)
    jy, jg, ty, tg = _vjp_both(lambda v: jfq.quantize_act(v, a_bit, variant=variant, impl=impl),
                               lambda v: tfq.quantize_act(v, a_bit, variant=variant, impl=impl), a, dtype)
    n = 2 ** (a_bit - 1) - 1 if variant == "int8" else 2**a_bit - 1
    _rounded_close(ty, jy, dtype, 2.0 * (2.0 if variant == "a" else 1.0) / n)
    np.testing.assert_array_equal(tg, jg) if a_bit == 32 else _close(tg, jg, dtype, rtol=1e-4)
    jy, jg, ty, tg = _vjp_both(lambda v: jfq.act_cdf(v, variant=variant, impl=impl),
                               lambda v: tfq.act_cdf(v, variant=variant, impl=impl), a, dtype)
    _close(ty, jy, dtype)
    _close(tg, jg, dtype, rtol=1e-4)


def test_poly_act_codes_are_the_deploy_codes():
    """At f32 the port's poly act site gives the INT graph's poly codes
    (kernels/quantize.py act_codes) exactly: train == deploy on the grid."""
    from alignq_tpu_torch.kernels.quantize import act_codes

    h = torch.tensor(_x(10, (1 << 14,), 1.5), dtype=torch.float32)
    y = tfq.quantize_act(h, 8, variant="int8", impl="poly")
    codes = torch.round(y / (2.0 / 127.0)).to(torch.int8)
    assert torch.equal(codes, act_codes(h, 127, "poly"))


def test_bad_variant_raises():
    with pytest.raises(ValueError):
        tfq.quantize_weight(torch.zeros(3, 3), 4, variant="c")
    with pytest.raises(ValueError):
        tfq.quantize_act(torch.zeros(3), 4, variant="c")
