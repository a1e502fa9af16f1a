"""The domain-adaptation train steps of alignq_tpu_torch (train/da.py) on
the CPU against the JAX package's, at float64.

Each case takes JAX's initial parameters (flax's init, its BatchNorm
affine drawn with numpy) and ADMM duals (numpy) into the port, then runs
three steps of the JAX step (eagerly: under jit XLA contracts the dequant
multiply and the residual add, and exact-zero residual ties take the other
relu branch) and of the port's on the same batches and ramps: parameters,
BatchNorm statistics, alter_d and gamma within 1e-9 after them. The
dropouts (the digit net's channel dropout, MDD's three) take JAX's masks,
recorded from flax's own draws (torch_port_helpers.record_dropout_masks):
jax.random's streams are not the port's. W4A4 with ADMM; ResNet-18 trunks
at 32x32, batch 4.

- digit: the digit DANN (plain SGD, as the digit driver), 28x28;
- dann: DANN on ResNet-18 with the AlignQ correction (the stem excluded);
- dsan: DSAN with the 256-wide bottleneck and LMMD; its one forward of
  both batches leaves the target pass's D, from which the duals update;
- mdd: MDD, a 32-wide bottleneck and heads.

And each model's train and eval forwards, gradients and statistics
within 1e-10. This file runs digit and dann;
tests/test_torch_da_steps_dsan_mdd.py runs dsan and mdd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from torch_port_helpers import flat_names, flax_da_init, port_masks, record_dropout_masks, site_duals, to_port_layout

from alignq_tpu.admm.state import ADMMSiteState
from alignq_tpu.models import dann as JD
from alignq_tpu.models import mdd as JM
from alignq_tpu.train import da as JDA
from alignq_tpu.train.state import TrainState as JState
from alignq_tpu.train.state import flatten_site_names
from alignq_tpu_torch import interop
from alignq_tpu_torch.models import DANN, DSAN, MDDNet, MNISTModelQuant
from alignq_tpu_torch.train import da as TDA
from alignq_tpu_torch.train.state import TrainState

TOL = dict(rtol=1e-9, atol=1e-9)
B = 4
STEPS = 3
pytestmark = pytest.mark.usefixtures("one_torch_thread")

Q = dict(w_bit=4, a_bit=4, admm=True)
CASES = {
    "digit": dict(jax=lambda: JD.mnist_model_quant(4, 4, admm=True), port=lambda: MNISTModelQuant(**Q), hw=28,
                  init=(0.0,), step="dann", heads=TDA.DANN_HEADS,
                  ramps=lambda: [float(JDA.grl_alpha(p)) for p in (0, .3, .6)],
                  cfg=dict(num_classes=10, use_correction=False, correction_exclude=())),
    "dann": dict(jax=lambda: JD.DANN(arch="resnet18", num_classes=5, **Q), port=lambda: DANN("resnet18", 5, **Q),
                 hw=32, init=(0.0,), step="dann", heads=TDA.DANN_HEADS,
                 ramps=lambda: [float(JDA.grl_alpha(p)) for p in (0, .3, .6)],
                 cfg=dict(num_classes=5, correction_exclude=("feature/conv1",))),
    "dsan": dict(jax=lambda: JD.DSAN(arch="resnet18", num_classes=5, **Q), port=lambda: DSAN("resnet18", 5, **Q),
                 hw=32, init=(), step="dsan", heads=TDA.DSAN_HEADS, ramps=lambda: [0.0, 0.46, 0.76],
                 cfg=dict(num_classes=5, correction_exclude=("feature_layers/conv1",))),
    "mdd": dict(jax=lambda: JM.MDDNet(arch="resnet18", num_classes=5, bottleneck_dim=32, width=32, **Q),
                port=lambda: MDDNet("resnet18", 5, 32, 32, **Q), hw=32, init=(0.0,), step="mdd",
                heads=TDA.MDD_HEADS, ramps=lambda: [float(JM.mdd_grl_coeff(i, max_iter=3)) for i in range(3)],
                cfg=dict(num_classes=5, correction_exclude=("base_network/conv1",))),
}


def _jax_sites(jm, params, stats, hw, init):
    _, v = jax.eval_shape(lambda p, x: jm.apply({"params": p, "batch_stats": stats}, x, *init, train=True,
                                               compute_corr=True, mutable=["admm_d", "batch_stats"],
                                               rngs={"dropout": jax.random.PRNGKey(0)}),
                          params, jnp.zeros((B, hw, hw, 3)))
    return sorted(flatten_site_names(v["admm_d"]))


def check_three_f64_steps(case):
    """Three f64 steps of the case's JAX and port steps, from JAX's init
    and duals: params, statistics and duals within 1e-9."""
    c = CASES[case]
    rng = np.random.RandomState(7)
    batches = [(rng.randn(B, c["hw"], c["hw"], 3), rng.randint(0, c["cfg"]["num_classes"], B),
                rng.randn(B, c["hw"], c["hw"], 3) + 0.3) for _ in range(STEPS)]
    kw = dict(train_batch_size=B, bitW=4, abitW=4, admm=True, lr=0.01, **c["cfg"])
    with jax.enable_x64(True):
        jm = c["jax"]()
        params, stats = flax_da_init(jm, c["hw"], *c["init"])
        jparams = jax.tree.map(jnp.asarray, params)
        sites = _jax_sites(jm, jparams, stats, c["hw"], c["init"])
        duals = site_duals(sites, B)
        jcfg = JDA.DAConfig(**kw)
        tx = JDA.make_da_optimizer(jcfg, jparams, 10, c["heads"])
        state = JState(step=jnp.zeros((), jnp.int32), params=jparams, batch_stats=jax.tree.map(jnp.asarray, stats),
                       opt_state=tx.init(jparams), tx=tx,
                       admm_duals={n: ADMMSiteState(jnp.asarray(a), jnp.asarray(g)) for n, (a, g) in duals.items()})
        jstep = getattr(JDA, f"make_{c['step']}_train_step")(jm, jcfg)
        ramps = c["ramps"]()
        masks = []
        for (xs, ys, xt), r in zip(batches, ramps):
            masks.append([])
            with record_dropout_masks(masks[-1]):
                state, _ = jstep(state, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(xt), r)
        want_p, want_s, want_d = jax.device_get((state.params, state.batch_stats, state.admm_duals))
    assert sites and len(masks[0]) == {"digit": 2, "mdd": 6}.get(case, 0)

    tm = c["port"]().double()
    interop.load_flax_tree(tm, params, stats)
    cfg = TDA.DAConfig(**kw)
    tstate = TrainState(0, tm, TDA.make_da_optimizer(cfg, dict(tm.named_parameters()), 10, c["heads"]),
                        interop.duals_from_jax(duals, "cpu", torch.float64))
    tstep = getattr(TDA, f"make_{c['step']}_train_step")(tm, cfg)
    for (xs, ys, xt), r, m in zip(batches, ramps, masks):
        tstep(tstate, torch.tensor(xs), torch.tensor(ys), torch.tensor(xt), r, rng=port_masks(m))
    assert tstate.step == STEPS and sorted(tstate.admm_duals) == sites

    want = flat_names(want_p)
    assert set(want) == set(tstate.params)
    for n, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), to_port_layout(n, want[n]), **TOL, err_msg=n)
    want = flat_names(want_s)
    assert set(want) == set(tstate.batch_stats)
    for n, s in tstate.batch_stats.items():
        np.testing.assert_allclose(s.numpy(), want[n], **TOL, err_msg=n)
    for n, s in tstate.admm_duals.items():
        np.testing.assert_allclose(s.alter_d.numpy(), np.asarray(want_d[n][0]), **TOL, err_msg=n)
        np.testing.assert_allclose(s.gamma.numpy(), np.asarray(want_d[n][1]), **TOL, err_msg=n)


def _outputs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def check_model_forward_and_grads(case):
    """One train forward (dropout masks JAX's) and one eval forward of
    each DA model on the same params: every output, the gradient of every
    parameter of sum(output * cotangent) + sum(D * cotangent), the new
    BatchNorm statistics and D within 1e-10 (gradients relative to their
    largest, where above 1)."""
    c = CASES[case]
    rng = np.random.RandomState(11)
    x, xt = rng.randn(B, c["hw"], c["hw"], 3), rng.randn(B, c["hw"], c["hw"], 3)
    tol = dict(rtol=1e-10, atol=1e-10)
    with jax.enable_x64(True):
        args = (jnp.asarray(xt),) if case == "dsan" else (0.4,)
        jm = c["jax"]()
        params, stats = flax_da_init(jm, c["hw"], *c["init"])
        shapes = jax.eval_shape(lambda p: jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), *args,
                                                   train=True, compute_corr=True, mutable=["admm_d", "batch_stats"],
                                                   rngs={"dropout": jax.random.PRNGKey(1)}), params)
        cots = [rng.randn(*s.shape) for s in jax.tree.leaves(shapes[0])]
        dcot = {n: rng.randn(*s.shape) for n, s in flatten_site_names(shapes[1]["admm_d"]).items()}

        def loss_fn(p):
            out, nv = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), *args, train=True,
                               compute_corr=True, mutable=["admm_d", "batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(1)})
            ds = flatten_site_names(nv["admm_d"])
            loss = sum(jnp.sum(o * g) for o, g in zip(jax.tree.leaves(out), cots))
            loss = loss + sum(jnp.sum(ds[n] * dcot[n]) for n in sorted(ds))
            return loss, (out, nv["batch_stats"], ds)

        masks = []
        with record_dropout_masks(masks):
            (_, (out, new_stats, ds)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                jax.tree.map(jnp.asarray, params))
        ev = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), *args, train=False)
        out, new_stats, ds, grads, ev = jax.device_get((out, new_stats, ds, grads, ev))

    tm = c["port"]().double()
    interop.load_flax_tree(tm, params, stats)
    targs = (torch.tensor(xt),) if case == "dsan" else (0.4,)
    with torch.no_grad():
        ev_t = _outputs(tm(torch.tensor(x), *targs, train=False))
    sink = {}
    out_t = _outputs(tm(torch.tensor(x), *targs, train=True, sink=sink, rng=port_masks(masks)))
    loss = sum((o * torch.tensor(g)).sum() for o, g in zip(out_t, cots))
    loss = loss + sum((sink[n] * torch.tensor(dcot[n])).sum() for n in sorted(sink))
    named = dict(tm.named_parameters())
    grads_t = dict(zip(named, torch.autograd.grad(loss, list(named.values()), allow_unused=True)))

    assert len(out_t) == len(jax.tree.leaves(out)) and sorted(sink) == sorted(ds)
    for o, w in zip(out_t, jax.tree.leaves(out)):
        np.testing.assert_allclose(o.detach().numpy(), w, **tol)
    for o, w in zip(ev_t, jax.tree.leaves(ev)):
        np.testing.assert_allclose(o.numpy(), w, **tol)
    for n in ds:
        np.testing.assert_allclose(sink[n].detach().numpy(), ds[n], **tol, err_msg=n)
    want = flat_names(grads)
    assert set(want) == set(grads_t)
    for n, g in grads_t.items():
        w = to_port_layout(n, want[n])
        g = np.zeros_like(w) if g is None else g.numpy()
        scale = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(g / scale, w / scale, **tol, err_msg=n)
    want = flat_names(new_stats)
    for n, s in tm.named_buffers():
        np.testing.assert_allclose(s.numpy(), want[n], **tol, err_msg=n)


# the digit net and DANN here; DSAN and MDD, which share DANN's trunk, in
# tests/test_torch_da_steps_dsan_mdd.py (each file compiles the trunk's
# eager JAX ops once; two files spread the ~6 minutes over two workers)
@pytest.mark.parametrize("case", ["digit", "dann"])
def test_three_f64_steps_match_jax(case):
    check_three_f64_steps(case)


@pytest.mark.parametrize("case", ["digit", "dann"])
def test_model_forward_and_grads_match_flax_at_f64(case):
    check_model_forward_and_grads(case)
