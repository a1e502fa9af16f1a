"""The port's ADMM modules (alignq_tpu_torch/admm) against the JAX
package's, on seeded numpy inputs.

Tolerances: f64 within 1e-12 (summation order only); f32 within rtol
1e-5 / atol 1e-6 for values, rtol 1e-4 / atol 1e-5 for gradients (the
B x B matrices are differences of near-equal correlations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignq_tpu.admm import correlation as jcorr
from alignq_tpu.admm import loss as jloss
from alignq_tpu.admm import state as jstate
from alignq_tpu_torch.admm import correlation as tcorr
from alignq_tpu_torch.admm import loss as tloss
from alignq_tpu_torch.admm import state as tstate

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
B, F = 8, 96


def _tol(dtype, grad=False):
    if dtype == "f64":
        return dict(rtol=1e-12, atol=1e-12)
    return dict(rtol=1e-4, atol=1e-5) if grad else dict(rtol=1e-5, atol=1e-6)


def _feats(seed, dtype, constant_col=False):
    x = np.random.RandomState(seed).randn(B, F).astype(DTYPES[dtype][0])
    if constant_col:
        x[:, 5] = 0.25  # a column constant across the batch
    return x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("eps", [0.0, 1e-5])
def test_corr(dtype, eps):
    x, y = _feats(0, dtype), _feats(1, dtype)
    with jax.enable_x64(dtype == "f64"):
        want = np.asarray(jcorr.corr(jnp.asarray(x), jnp.asarray(y), eps=eps))
    got = tcorr.corr(torch.tensor(x), torch.tensor(y), eps=eps)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, B)
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("constant_col", [False, True])
def test_corr_discrepancy_and_its_gradient(dtype, constant_col):
    """D and dD/dx under one cotangent, finite with a column constant
    across the batch. That column's gradient runs through 1/eps (its
    centered values are 0 over std + eps), so it is compared at rtol 1e-2
    at f32, the other columns at the file's tolerance."""
    x = _feats(2, dtype, constant_col)
    cot = np.random.RandomState(3).randn(B, B).astype(DTYPES[dtype][0])

    def jd(a):
        return jcorr.corr_discrepancy(a, jnp.tanh(a), eps=1e-5)

    with jax.enable_x64(dtype == "f64"):
        jy, vjp = jax.vjp(jd, jnp.asarray(x))
        (jg,) = vjp(jnp.asarray(cot))
        jy, jg = np.asarray(jy), np.asarray(jg)
    xt = torch.tensor(x, requires_grad=True)
    ty = tcorr.corr_discrepancy(xt, torch.tanh(xt), eps=1e-5)
    (tg,) = torch.autograd.grad(ty, xt, torch.tensor(cot))
    tg = tg.numpy()
    assert np.isfinite(tg).all()
    np.testing.assert_allclose(ty.detach().numpy(), jy, **_tol(dtype))
    rest = np.arange(F) != 5 if constant_col else np.ones(F, bool)
    np.testing.assert_allclose(tg[:, rest], jg[:, rest], **_tol(dtype, grad=True))
    np.testing.assert_allclose(tg[:, ~rest], jg[:, ~rest], rtol=1e-2 if dtype == "f32" else 1e-9)


@pytest.mark.parametrize("dtype", DTYPES)
def test_safe_std_gradient_is_zero_on_a_constant_column(dtype):
    """sqrt's infinite derivative at variance 0 would give NaN; the double
    where gives 0 there, as in the JAX package."""
    x = _feats(6, dtype, constant_col=True)
    with jax.enable_x64(dtype == "f64"):
        jg = np.asarray(jax.grad(lambda a: jcorr._safe_std(a).sum())(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    (tg,) = torch.autograd.grad(tcorr._safe_std(xt).sum(), xt)
    assert torch.all(tg[:, 5] == 0) and np.all(jg[:, 5] == 0)
    np.testing.assert_allclose(tg.numpy(), jg, **_tol(dtype, grad=True))


@pytest.mark.parametrize("dtype", DTYPES)
def test_admm_loss_value_and_gradient_in_d_only(dtype):
    rng = np.random.RandomState(4)
    d, z, gamma = (rng.randn(B, B).astype(DTYPES[dtype][0]) for _ in range(3))
    cfg_j, cfg_t = jloss.ADMMConfig(mu=0.2, rho=0.3), tloss.ADMMConfig(mu=0.2, rho=0.3)
    with jax.enable_x64(dtype == "f64"):
        jv, (jgd, jgz, jgg) = jax.value_and_grad(lambda a, b, c: jloss.admm_loss(a, b, c, cfg_j), argnums=(0, 1, 2))(
            jnp.asarray(d), jnp.asarray(z), jnp.asarray(gamma))
    ts = [torch.tensor(a, requires_grad=True) for a in (d, z, gamma)]
    tv = tloss.admm_loss(*ts, cfg_t)
    tgd, = torch.autograd.grad(tv, ts[0])
    np.testing.assert_allclose(float(tv.detach()), float(jv), **_tol(dtype))
    np.testing.assert_allclose(tgd.numpy(), np.asarray(jgd), **_tol(dtype, grad=True))
    # Z and gamma are assigned in closed form, never differentiated
    assert not np.any(np.asarray(jgz)) and not np.any(np.asarray(jgg))
    tz = torch.tensor(z, requires_grad=True)
    assert not tloss.admm_loss(torch.tensor(d), tz, torch.tensor(gamma)).requires_grad


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_dual_update(dtype, scale):
    """Both branches of the soft threshold: ||V|| above mu/rho (scale 1)
    and below it (scale 1e-3, Z = 0)."""
    rng = np.random.RandomState(5)
    d, z, gamma = ((rng.randn(B, B) * scale).astype(DTYPES[dtype][0]) for _ in range(3))
    with jax.enable_x64(dtype == "f64"):
        want = jstate.dual_update(jstate.ADMMSiteState(jnp.asarray(z), jnp.asarray(gamma)), jnp.asarray(d))
    got = tstate.dual_update(tstate.ADMMSiteState(torch.tensor(z), torch.tensor(gamma)), torch.tensor(d))
    np.testing.assert_allclose(got.alter_d.numpy(), np.asarray(want.alter_d), **_tol(dtype))
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(want.gamma), **_tol(dtype))
    assert bool((got.alter_d == 0).all()) == (scale < 1)


def test_dual_update_tree_and_init_site():
    gen = torch.Generator().manual_seed(0)
    states = {n: tstate.init_site(gen, B) for n in ("a/d", "b/d")}
    for s in states.values():
        assert s.alter_d.shape == (B, B) and s.gamma.dtype == torch.float32
        assert 0 <= float(s.alter_d.min()) and float(s.gamma.max()) < 1
    assert not torch.equal(states["a/d"].alter_d, states["b/d"].alter_d)
    d = torch.randn(B, B, generator=gen)
    new = tstate.dual_update_tree(states, {"a/d": d})
    assert new["b/d"] is states["b/d"]
    want = tstate.dual_update(states["a/d"], d)
    assert torch.equal(new["a/d"].gamma, want.gamma)
