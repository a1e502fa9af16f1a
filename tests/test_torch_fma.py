"""The port's f32 multiply-add (alignq_tpu_torch/quant/cdf.py fma_f32)
against jitted JAX's `a * b + c`, which XLA contracts into one f32 fused
multiply-add on the CPU: bit for bit, on triples whose exact result lies
at, just above or just below an f32 rounding midpoint (where a float64
add followed by a cast rounds twice) and on 100,000 random triples; with
subnormal f32 results, against the exact result rounded once (jitted JAX
flushes those to zero). Tolerance: none (int32 views compared)."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignq_tpu_torch.quant.cdf import _fma, fma_f32

_JIT_FMA = jax.jit(lambda a, b, c: a * b + c)


def _both(a, b, c):
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    want = np.asarray(_JIT_FMA(a, b, c))
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    return got, want


def _assert_bits(got, want):
    diff = got.view(np.int32) != want.view(np.int32)
    assert not diff.any(), f"{int(diff.sum())} of {diff.size} differ: got {got[diff][:4]}, JAX {want[diff][:4]}"


def test_xla_contracts_the_multiply_add():
    hlo = _JIT_FMA.lower(jnp.float32(1), jnp.float32(1), jnp.float32(1)).compile().as_text()
    assert "fma" in hlo


def test_the_double_rounding_triple():
    """a = b = f32(1 + 2^-12), c = f32(2^-60): the exact result is just
    above the midpoint 1 + 2^-11 + 2^-24; one rounding gives 1 + 2^-11 +
    2^-23, a float64 add and a cast gave 1 + 2^-11."""
    a = np.float32(1 + 2.0**-12)
    got, want = _both(a, a, np.float32(2.0**-60))
    assert float(want) == 1 + 2.0**-11 + 2.0**-23
    _assert_bits(got, want)


def _midpoint_triples():
    """a = s (1 + i 2^-12), b = t (1 + j 2^-12) with i j odd: a * b is an f32
    midpoint (its 2^-24 term), scaled by s t; c moves it above or below by
    less than a float64 ulp, by a representable step, or not at all."""
    a, b, c = [], [], []
    for i in range(1, 40, 3):
        for j in range(1, 40, 4):
            if i * j % 2 == 0:
                continue
            for sa, sb in ((1.0, 1.0), (2.0**-20, 2.0**7), (-1.0, 1.0), (2.0**60, 2.0**-61)):
                prod_scale = sa * sb
                for dc in (0.0, 2.0**-60, -(2.0**-60), 2.0**-70, -(2.0**-70), 2.0**-40, -(2.0**-40)):
                    a.append(sa * (1 + i * 2.0**-12))
                    b.append(sb * (1 + j * 2.0**-12))
                    c.append(abs(prod_scale) * dc)
    return np.array(a, np.float32), np.array(b, np.float32), np.array(c, np.float32)


def test_midpoint_adjacent_triples():
    a, b, c = _midpoint_triples()
    got, want = _both(a, b, c)
    _assert_bits(got, want)
    # the family reaches the double rounding: the float64 add and one cast part from JAX
    twice = (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)
    assert (twice.view(np.int32) != want.view(np.int32)).sum() > 0


@pytest.mark.parametrize("scale", [2.0**-75, 2.0**-74, 2.0**-70], ids=["tie_at_2^-150", "2^-148", "2^-140"])
def test_subnormal_results(scale):
    """Products at and around subnormal f32 midpoints, with c 0, the
    smallest subnormal or its negative. Jitted JAX on the CPU flushes a
    subnormal result to zero, and `__fmaf_rn` (built without -ftz) and
    fma_f32 keep it; so these are held to the exact result rounded once:
    every exact sum here fits in float64 (checked with Fraction), and its
    cast to f32 is then the one rounding."""
    base = np.array([1.0, 1 + 2.0**-23, 1 - 2.0**-24, 1 + 2.0**-12, 1.5, 3.0], np.float64)
    a = np.repeat((base * scale).astype(np.float32), 3 * len(base))
    b = np.tile(np.repeat((base * scale).astype(np.float32), 3), len(base))
    tiny = np.float32(2.0**-149)
    c = np.tile(np.array([0.0, tiny, -tiny], np.float32), len(base) ** 2)
    exact = a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)
    for x, y, z, e in zip(a, b, c, exact):
        assert Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)) == Fraction(float(e))
    want = exact.astype(np.float32)
    assert ((want != 0) & (np.abs(want) < np.finfo(np.float32).tiny)).any()
    got = fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    _assert_bits(got, want)


def test_random_triples():
    r = np.random.RandomState(0)
    n = 100_000
    a = r.randn(n).astype(np.float32)
    b = (r.randn(n) * 2.0 ** r.randint(-20, 20, n)).astype(np.float32)
    c = (r.randn(n) * 2.0 ** r.randint(-40, 20, n)).astype(np.float32)
    _assert_bits(*_both(a, b, c))


def test_gradient_is_that_of_the_multiply_add():
    """Under autograd the rounding is a constant: d/da = b, d/db = a, d/dc = 1
    (the QAT act sites' poly Horner steps run through _fma)."""
    a = torch.tensor([1 + 2.0**-12, 0.5], requires_grad=True)
    b = torch.tensor([1 + 2.0**-12, 3.0], requires_grad=True)
    c = torch.tensor([2.0**-60, 1.0], requires_grad=True)
    y = _fma(a, b, c)
    assert y.dtype == torch.float32 and y[0].item() == 1 + 2.0**-11 + 2.0**-23
    y.sum().backward()
    assert torch.equal(a.grad, b.detach()) and torch.equal(b.grad, a.detach()) and torch.equal(c.grad, torch.ones(2))


def test_erf_f32_recomputes_flagged_elements(monkeypatch):
    """erf_f32 casts its Horner steps from float64 and evaluates the
    elements flagged as possible double roundings again by fma_f32: with
    every element flagged the result is the same, and jax.lax.erf's bit
    for bit."""
    from alignq_tpu_torch.quant import cdf

    x = torch.from_numpy(np.random.RandomState(1).randn(4096).astype(np.float32) * 2)
    want = np.asarray(jax.jit(jax.lax.erf)(x.numpy()))
    _assert_bits(cdf.erf_f32(x).numpy(), want)
    monkeypatch.setattr(cdf, "_double_rounding_candidates", lambda s, r: torch.ones_like(s, dtype=torch.bool))
    _assert_bits(cdf.erf_f32(x).numpy(), want)
