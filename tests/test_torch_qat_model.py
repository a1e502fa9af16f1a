"""The port's QAT model (alignq_tpu_torch/nn/layers.py BatchNorm and
models/resnet_cifar.py PreActResNet) against flax's, at f64.

A PreActResNet with num_units=(1, 1, 1) (stem, one identity block, two
stride-2 blocks) on 8x8 images, flax's init carried across. One train
forward with every ADMM site collected and one backward of CE + the sum of
the sites' ADMM losses (duals drawn with numpy) on both sides, eagerly:
logits, every parameter gradient, the new BatchNorm statistics and the
sites' D. Tolerance: 1e-10 absolute and relative at f64 (conv summation
order only). The JAX step runs eagerly: under jit XLA contracts the
dequant multiply and the residual add into one rounding, and the exact-zero
residual ties then take the other relu branch (tests/test_trajectory_parity_full.py). BatchNorm alone is also held to flax at f32 (rtol 1e-5,
atol 1e-6) over 3 train forwards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import f64_tree, flat_names, one_torch_thread, to_port_layout  # noqa: F401

from alignq_tpu.admm.loss import admm_loss as j_admm_loss
from alignq_tpu.models.resnet_cifar import PreActResNet as JNet
from alignq_tpu.nn.layers import BatchNorm as JBatchNorm
from alignq_tpu.train.state import flatten_site_names
from alignq_tpu_torch.admm.loss import admm_loss as t_admm_loss
from alignq_tpu_torch.interop import deploy_tree, load_flax_preact
from alignq_tpu_torch.models.resnet_cifar import PreActResNet as TNet
from alignq_tpu_torch.nn.layers import BatchNorm as TBatchNorm
from alignq_tpu_torch.nn.layers import QuantAct

B, HW = 4, 8
TOL = dict(rtol=1e-10, atol=1e-10)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_batchnorm_three_train_forwards(dtype):
    """flax's rule: biased fast variance, momentum 0.9 in flax's sense."""
    npd, td = (np.float32, torch.float32) if dtype == "f32" else (np.float64, torch.float64)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "f32" else TOL
    rng = np.random.RandomState(0)
    xs = [(rng.randn(6, 5, 5, 7) * 2 + 0.5).astype(npd) for _ in range(3)]
    scale, bias = (rng.rand(7) + 0.5).astype(npd), rng.randn(7).astype(npd)
    with jax.enable_x64(dtype == "f64"):
        bn = JBatchNorm(use_running_average=False)
        v = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
        params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
        stats = jax.tree.map(lambda a: a.astype(npd), v["batch_stats"])
        ys = []
        for x in xs:
            y, nv = bn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), mutable=["batch_stats"])
            stats = nv["batch_stats"]
            ys.append(np.asarray(y))
        y_eval = np.asarray(JBatchNorm(use_running_average=True).apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(xs[0])))
    tbn = TBatchNorm(7).to(td)
    with torch.no_grad():
        tbn.scale.copy_(torch.tensor(scale))
        tbn.bias.copy_(torch.tensor(bias))
    for x, want in zip(xs, ys):
        got = tbn(torch.tensor(x).permute(0, 3, 1, 2), train=True)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), want, **tol)
    np.testing.assert_allclose(tbn.mean.numpy(), np.asarray(stats["mean"]), **tol)
    np.testing.assert_allclose(tbn.var.numpy(), np.asarray(stats["var"]), **tol)
    got = tbn(torch.tensor(xs[0]).permute(0, 3, 1, 2), train=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), y_eval, **tol)
    # torch's own BatchNorm2d would keep the UNBIASED running variance
    ref = torch.nn.BatchNorm2d(7, momentum=0.1).to(td)
    for x in xs:
        ref(torch.tensor(x).permute(0, 3, 1, 2))
    assert not np.allclose(ref.running_var.numpy(), tbn.var.numpy(), rtol=1e-3)


CONFIGS = {
    "ours-erf-W4A4-admm": dict(w_bit=4, a_bit=4, admm=True),
    "ours-poly-W4A4-admm": dict(w_bit=4, a_bit=4, admm=True, cdf_impl="poly"),
    "ours-erf-W8A8-b": dict(w_bit=8, a_bit=8),
    "fp": dict(method="fp"),
    "deploy_exact-int8-poly-W8A8-admm": dict(w_bit=8, a_bit=8, variant="int8", deploy_exact=True,
                                             cdf_impl="poly", admm=True),
    "deploy_exact-stream_int8-W4A4": dict(w_bit=4, a_bit=4, variant="int8", deploy_exact=True, stream_int8=True),
    "block_bits-2-4-8": dict(a_bit=4, block_bits=(2, 4, 8), admm=True),
}


def _duals(names):
    out = {}
    for i, n in enumerate(sorted(names)):
        r = np.random.RandomState(100 + i)
        out[n] = (r.rand(B, B), r.rand(B, B))
    return out


def _flax_step(jm, params, stats, x, y):
    """JAX: logits, grads, new batch stats and the sites' D, eagerly at f64."""

    def loss_fn(p):
        logits, nv = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True, compute_corr=True,
                              mutable=["batch_stats", "admm_d"])
        ce = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)))
        ds = flatten_site_names(nv.get("admm_d", {}))
        duals = _duals(ds)
        trans = 0.0
        for n in sorted(ds):
            trans = trans + j_admm_loss(ds[n], jnp.asarray(duals[n][0]), jnp.asarray(duals[n][1]))
        return ce + trans, (logits, nv["batch_stats"], ds)

    (loss, (logits, new_stats, ds)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return jax.device_get((loss, logits, grads, new_stats, ds))


@pytest.mark.parametrize("name", CONFIGS)
def test_preact_resnet_matches_flax_at_f64(name):
    kw = CONFIGS[name]
    rng = np.random.RandomState(1)
    x, y = rng.randn(B, HW, HW, 3), rng.randint(0, 10, B)
    with jax.enable_x64(True):
        jm = JNet(num_units=(1, 1, 1), **kw)
        v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
        params = f64_tree(jax.device_get(v["params"]))
        stats = f64_tree(jax.device_get(v["batch_stats"]))
        # non-trivial running statistics for the eval forward
        stats = jax.tree.map(lambda a: a + 0.1 * np.random.RandomState(a.size).rand(*a.shape), stats)
        loss, logits, grads, new_stats, ds = _flax_step(jm, jax.tree.map(jnp.asarray, params), stats, x, y)
        eval_logits = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(
            {"params": params, "batch_stats": stats}, jnp.asarray(x)))

    tm = TNet(num_units=(1, 1, 1), **kw).double()
    load_flax_preact(tm, params, stats)
    got_eval = tm(torch.tensor(x), train=False)
    np.testing.assert_allclose(got_eval.detach().numpy(), eval_logits, **TOL)

    sink = {}
    logits_t = tm(torch.tensor(x), train=True, sink=sink)
    duals = _duals(sink)
    loss_t = torch.nn.functional.cross_entropy(logits_t, torch.tensor(y))
    trans = 0.0
    for n in sorted(sink):
        trans = trans + t_admm_loss(sink[n], torch.tensor(duals[n][0]), torch.tensor(duals[n][1]))
    loss_t = loss_t + trans
    named = dict(tm.named_parameters())
    g = dict(zip(named, torch.autograd.grad(loss_t, list(named.values()))))

    assert sorted(sink) == sorted(ds)
    assert len(ds) == (9 if kw.get("admm") else 0)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss), **TOL)
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits), **TOL)
    for n in ds:
        np.testing.assert_allclose(sink[n].detach().numpy(), np.asarray(ds[n]), **TOL, err_msg=n)
    want_g = flat_names(grads)
    assert set(want_g) == set(g)
    for n, gg in g.items():
        np.testing.assert_allclose(gg.numpy(), to_port_layout(n, want_g[n]), **TOL, err_msg=n)
    want_s = flat_names(new_stats)
    for n, s in tm.named_buffers():
        np.testing.assert_allclose(s.numpy(), want_s[n], **TOL, err_msg=n)


def test_site_names_and_deploy_tree_round_trip():
    """The ADMM site names are flax's paths; deploy_tree gives back the
    flax tree that was loaded, bit for bit (HWIO kernels)."""
    with jax.enable_x64(True):
        jm = JNet(num_units=(1, 1, 1), admm=True)
        v = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, HW, HW, 3)))
    params, stats = f64_tree(jax.device_get(v["params"])), f64_tree(jax.device_get(v["batch_stats"]))
    tm = TNet(num_units=(1, 1, 1), admm=True).double()
    load_flax_preact(tm, params, stats)
    sites = sorted(m.site for m in tm.modules() if isinstance(m, QuantAct))
    assert sites == ["act_q0/d", "layers_0/act_q0/d", "layers_0/act_q1/d", "layers_1/act_q0/d",
                     "layers_1/act_q1/d", "layers_1/act_skip_q/d", "layers_2/act_q0/d", "layers_2/act_q1/d",
                     "layers_2/act_skip_q/d"]
    p2, s2 = deploy_tree(tm)
    for want, got in ((flat_names(params), flat_names(p2)), (flat_names(stats), flat_names(s2))):
        assert set(want) == set(got)
        for n in want:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    with pytest.raises(ValueError):
        load_flax_preact(TNet(num_units=(1, 1, 2)), params, stats)


def test_unported_methods_raise():
    """Every method of the JAX package is ported (tests/test_torch_baselines.py);
    a method JAX raises on raises here too."""
    for method in ("uniform", "lsq", "apot"):
        TNet(num_units=(1, 1, 1), method=method)
    for method in ("awq", "ours2"):
        with pytest.raises(ValueError, match="unknown quant method"):
            TNet(num_units=(1, 1, 1), method=method)
        with jax.enable_x64(True), pytest.raises(KeyError):  # JAX's ORDERING lookup
            JNet(num_units=(1, 1, 1), method=method).init(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
    with pytest.raises(ValueError):
        TNet(num_units=(1, 1, 1), stream_int8=True)


def test_mxu_bf16_convs():
    """mxu_dtype: bf16 conv operands, f32 output; close to the f32 forward."""
    x = torch.tensor(np.random.RandomState(2).randn(B, HW, HW, 3), dtype=torch.float32)
    tm = TNet(num_units=(1, 1, 1), generator=torch.Generator().manual_seed(0))
    tb = TNet(num_units=(1, 1, 1), mxu_dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref, got = tm(x), tb(x)
    assert got.dtype == torch.float32
    assert float((got - ref).abs().max()) < 0.5
