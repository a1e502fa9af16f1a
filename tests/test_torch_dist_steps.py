"""The port's data-parallel train steps (alignq_tpu_torch/train/steps.py,
dist/corr.py) against the JAX package's, one step each, at float64.

Two gloo ranks on the CPU (subprocesses, torch only) take the halves of
a batch of 8; JAX runs in this process over 2 of the 8 virtual CPU
devices (tests/conftest.py) under jax.enable_x64:
- gather mode: JAX's one-device step jitted over a batch sharded on a
  2-device mesh (GSPMD inserts every collective), against the port's
  step, whose couplings are explicit (dist/collectives.py);
- local mode with each compression (f32, bf16, int8_gather): JAX's
  make_local_corr_train_step with create_local_duals' values carried
  across, against the port's;
Parameters, BatchNorm statistics, `amax`, the duals and the metrics within
1e-9 (the bf16 and int8 wire formats round the gradients alike on both
sides). The net is a depth-10 DenseNet, W8A8 deploy_exact with ADMM, on
8x8 images, its leaves drawn with numpy: it has no residual add, whose
exact-zero ties XLA's contraction moves under jit (a PreActResNet's jitted
JAX step differs from JAX's own eager one by ~2e-3 at W4A4 and f64, which
the port follows, tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P
from torch_port_helpers import (  # noqa: F401
    affine_bn_tree,
    f64_tree,
    flat_names,
    one_torch_thread,
    random_densenet_tree,
    run_ranks,
    to_port_layout,
)

from alignq_tpu.dist import make_mesh, shard_batch
from alignq_tpu.dist.corr import create_local_duals, make_local_corr_train_step
from alignq_tpu.models.densenet import DenseNet as JDense
from alignq_tpu.models.resnet_cifar import PreActResNet as JNet
from alignq_tpu.train import state as jstate
from alignq_tpu.train import steps as jsteps
from alignq_tpu.train.config import TrainConfig as JConfig

TOL = dict(rtol=1e-9, atol=1e-9)
B, N = 8, 2
COMPRESSIONS = ("f32", "bf16", "int8_gather")
KW = dict(train_batch_size=B, admm=True, lr=0.02, momentum=0.9, weight_decay=1e-4, lam=1.0, lam2=4.0,
          admm_mu=0.2, admm_rho=0.3, lr_decay_steps=(1000,))


def _jax_state(jm, jcfg, hw, params=None, stats=None):
    """JAX's f64 train state (jitted init) with the given trees, or its
    init's with every BatchNorm affine drawn."""
    with jax.enable_x64(True):
        js = jax.jit(lambda r: jstate.create_train_state(r, jm, jcfg, input_shape=(1, hw, hw, 3),
                                                          steps_per_epoch=10_000))(jax.random.PRNGKey(0))
        if params is None:
            params = affine_bn_tree(f64_tree(jax.device_get(js.params)))
            stats = f64_tree(jax.device_get(js.batch_stats))
        params = jax.tree.map(jnp.asarray, params)
        return js.replace(params=params, batch_stats=jax.tree.map(jnp.asarray, stats),
                          admm_duals=jax.tree.map(lambda a: a.astype(jnp.float64), js.admm_duals),
                          opt_state=js.tx.init(params))


def _arrays(js, local_duals=None):
    """The port's p:, b:, a:/g: (and la:/lg:) arrays of a JAX state."""
    out = {f"p:{k}": to_port_layout(k, v) for k, v in flat_names(jax.device_get(js.params)).items()}
    out.update({f"b:{k}": v for k, v in flat_names(jax.device_get(js.batch_stats)).items()})
    for k, s in js.admm_duals.items():
        out[f"a:{k}"], out[f"g:{k}"] = np.asarray(s.alter_d), np.asarray(s.gamma)
    for k, s in (local_duals or {}).items():
        out[f"la:{k}"], out[f"lg:{k}"] = np.asarray(s.alter_d), np.asarray(s.gamma)
    return out


def _assert_state(got, tag, js, duals, rank=None):
    want = flat_names(jax.device_get(js.params))
    for k, v in want.items():
        np.testing.assert_allclose(got[f"{tag}p:{k}"], to_port_layout(k, v), **TOL, err_msg=tag + k)
    for k, v in flat_names(jax.device_get(js.batch_stats)).items():
        np.testing.assert_allclose(got[f"{tag}b:{k}"], v, **TOL, err_msg=tag + k)
    for k, s in duals.items():
        a, g = np.asarray(s.alter_d), np.asarray(s.gamma)
        if rank is not None:
            a, g = a[rank], g[rank]
        np.testing.assert_allclose(got[f"{tag}a:{k}"], a, **TOL, err_msg=f"{tag}alterD {k}")
        np.testing.assert_allclose(got[f"{tag}g:{k}"], g, **TOL, err_msg=f"{tag}gamma {k}")


def _run_port(tmp_path, arrays, x, y, model, cases, correction_exclude):
    np.savez(tmp_path / "state.npz", **arrays)
    np.savez(tmp_path / "batch.npz", x=x, y=y)
    spec = dict(kind="steps", state=str(tmp_path / "state.npz"), batch=str(tmp_path / "batch.npz"), model=model,
                cases=cases, lr=KW["lr"], correction_exclude=list(correction_exclude),
                out=str(tmp_path / "out_{rank}.npz"))
    run_ranks(N, spec, tmp_path)
    return [dict(np.load(tmp_path / f"out_{r}.npz")) for r in range(N)]


DENSE = dict(depth=10, w_bit=8, a_bit=8, variant="int8", deploy_exact=True, admm=True)


def _dense_case(tmp_path, stage_int8, cases, seed):
    """JAX's steps of each (mode, compression) case and the port's two
    ranks' from one DenseNet state (leaves drawn with numpy, f64)."""
    kw = dict(DENSE, stage_int8=stage_int8, stage_calib="ema")
    params, stats = (f64_tree(t) for t in random_densenet_tree(10, seed, stage_int8=stage_int8))
    jm = JDense(**kw)
    js0 = _jax_state(jm, JConfig(bitW=8, abitW=8, correction_exclude=(), **KW), 8, params, stats)
    rng = np.random.RandomState(seed)
    x, y = rng.randn(B, 8, 8, 3), rng.randint(0, 10, B)
    mesh = make_mesh((N,), ("data",), jax.devices()[:N])
    want = {}
    with jax.enable_x64(True):
        local0 = jax.tree.map(lambda a: a.astype(jnp.float64),
                              create_local_duals(jax.random.PRNGKey(4), sorted(js0.admm_duals), JConfig(**KW), N))
        xs, ys = shard_batch((jnp.asarray(x), jnp.asarray(y)), mesh)
        for mode, c in cases:
            cfg = JConfig(bitW=8, abitW=8, correction_exclude=(), grad_compression=c, **KW)
            if mode == "gather":
                rep = NamedSharding(mesh, P())
                want[mode, c] = jax.jit(jsteps.make_train_step(jm, cfg))(jax.device_put(js0, rep), xs, ys)
            else:
                want[mode, c] = make_local_corr_train_step(jm, cfg, mesh)(js0.replace(admm_duals=local0), xs, ys)
        want = jax.device_get(want)
    model = dict(kind="densenet", bits=8, admm=True, calib="ema", stage_int8=stage_int8)
    outs = _run_port(tmp_path, _arrays(js0, local0), x, y, model, [list(c) for c in cases], ())
    for (mode, c), (js, metrics) in want.items():
        tag = f"{mode}/{c}/"
        for r, got in enumerate(outs):
            _assert_state(got, tag, js, js.admm_duals, r if mode == "local" else None)
            for k in ("loss", "ce", "trans", "accuracy"):
                np.testing.assert_allclose(got[f"{tag}m:{k}"], float(metrics[k]), **TOL, err_msg=tag + k)
            assert int(got[f"{tag}step"]) == 1
    return outs, want


def test_gather_and_local_steps_match_jax(tmp_path):
    """One gather step and one local step of each compression, two ranks,
    against JAX's jitted steps at f64 within 1e-9; both ranks end alike
    (but for their own shard of the local duals)."""
    cases = [("gather", "f32")] + [("local", c) for c in COMPRESSIONS]
    outs, _ = _dense_case(tmp_path, False, cases, 11)
    # the compressed means round the gradients: bf16 and int8 move the
    # parameters off the f32 mean's, and the port moves them as JAX does
    p = "p:dense2_0.conv1.kernel"
    for c in ("bf16", "int8_gather"):
        assert not np.array_equal(outs[0][f"local/{c}/{p}"], outs[0][f"local/f32/{p}"])
