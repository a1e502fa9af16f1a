"""The port's training half (alignq_tpu_torch/{optim,train,data}) against
the JAX package's.

- alignq_sgd against optax's chain over 3 steps, correction on and off;
  multistep_schedule at and around its boundaries; the correction mask;
- the slice as a whole: 10 steps of make_train_step with ADMM and the
  correction, W4A4, batch 8, PreActResNet num_units=(1, 1, 1) on 8x8
  images, from JAX's init, data and duals carried across, at f64. JAX
  runs eagerly inside jax.enable_x64(True) (under jit XLA contracts the
  dequant multiply and the residual add, and the exact-zero residual ties
  take the other relu branch: tests/test_trajectory_parity_full.py).
  Params, BatchNorm statistics, alterD and gamma within atol 1e-6 / rtol
  1e-5, that test's tolerance; then one full-depth ResNet-20 step the
  same way;
- same-seed loader batches equal to alignq_tpu.data's;
- the checkpoint round trip and the CLI on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import f64_tree, flat_names, one_torch_thread, to_port_layout, write_tiny_cifar10  # noqa: F401

from alignq_tpu.models.resnet_cifar import PreActResNet as JNet
from alignq_tpu.optim import correction as jcorrection
from alignq_tpu.optim import factory as jfactory
from alignq_tpu.optim import schedules as jschedules
from alignq_tpu.train import state as jstate
from alignq_tpu.train import steps as jsteps
from alignq_tpu.train.config import TrainConfig as JConfig
from alignq_tpu_torch.interop import duals_from_jax, load_flax_preact
from alignq_tpu_torch.models.resnet_cifar import PreActResNet as TNet
from alignq_tpu_torch.optim import correction as tcorrection
from alignq_tpu_torch.optim import factory as tfactory
from alignq_tpu_torch.optim import schedules as tschedules
from alignq_tpu_torch.train import state as tstate
from alignq_tpu_torch.train import steps as tsteps
from alignq_tpu_torch.train.config import TrainConfig as TConfig

TRAJ_TOL = dict(atol=1e-6, rtol=1e-5)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _flax_like_params(dtype, seed=0):
    """A flax-layout tree with conv kernels, a head, a BN scale and bias."""
    r = np.random.RandomState(seed)
    return {
        "conv0": {"kernel": (r.randn(3, 3, 3, 8) * 0.2).astype(dtype)},
        "layers_0": {"conv0": {"kernel": (r.randn(3, 3, 8, 8) * 0.1).astype(dtype)},
                     "skip_conv": {"kernel": (r.randn(1, 1, 8, 16) * 0.3).astype(dtype)},
                     "bn0": {"scale": (r.rand(8) + 0.5).astype(dtype), "bias": r.randn(8).astype(dtype)}},
        "logit": {"kernel": (r.randn(16, 10) * 0.2).astype(dtype), "bias": r.randn(10).astype(dtype)},
    }


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("use_correction", [True, False])
def test_alignq_sgd_against_optax(dtype, use_correction):
    """Decay, momentum trace, the correction on the masked leaves from the
    pre-update weights, then -lr (a schedule with a boundary at step 2):
    three steps. f64 within 1e-12; f32 within rtol 1e-5 / atol 2e-6: the
    correction's bin phase (c + 0.5) * (2^k - 1) mod 1 jumps from ~1 to 0
    where an ulp of c crosses an integer, which moves sigma' from ~0 to
    1/4 on those few elements (lr * |u| * pdf / 4 < 2e-6 here)."""
    npd = np.float32 if dtype == "f32" else np.float64
    tol = dict(rtol=1e-5, atol=2e-6) if dtype == "f32" else dict(rtol=1e-12, atol=1e-12)
    params = _flax_like_params(npd)
    grads = [jax.tree.map(lambda a, s=s: (np.random.RandomState(s + a.size).randn(*a.shape) * 0.1).astype(npd),
                          params) for s in range(3)]
    kw = dict(momentum=0.9, weight_decay=1e-4, w_bit=4, lam=1.0, lam2=4.0, use_correction=use_correction)
    with jax.enable_x64(dtype == "f64"):
        jp = jax.tree.map(jnp.asarray, params)
        mask = jcorrection.build_correction_mask(jp, exclude=("conv0",))
        tx = jfactory.alignq_sgd(jschedules.multistep_schedule(0.05, (1,), 0.1, 2), correction_mask=mask, **kw)
        opt = tx.init(jp)
        for g in grads:
            upd, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, jp)
            jp = optax.apply_updates(jp, upd)
        want = flat_names(jax.device_get(jp))

    tp = {n: torch.tensor(to_port_layout(n, a)) for n, a in flat_names(params).items()}
    tmask = tcorrection.build_correction_mask(tp, exclude=("conv0",))
    assert tmask == {n: bool(v) for n, v in flat_names(mask).items()}
    opt_t = tfactory.alignq_sgd(tschedules.multistep_schedule(0.05, (1,), 0.1, 2), correction_mask=tmask, **kw)
    for g in grads:
        opt_t.step(tp, {n: torch.tensor(to_port_layout(n, a)) for n, a in flat_names(g).items()})
    assert opt_t.count == 3
    for n, t in tp.items():
        np.testing.assert_allclose(t.numpy(), to_port_layout(n, want[n]), **tol, err_msg=n)


def test_multistep_schedule_boundaries_and_warmup():
    """optax's boundary semantics: the decay applies from the step equal
    to the boundary on; repeated boundaries count once; warmup; a
    boundary past the int32 step counter never decays."""
    for args, kw in (((0.04, (2, 4), 0.1, 10), {}), ((0.04, (2, 2, 3), 0.5, 10), {}),
                     ((0.1, (2, 4), 0.1, 10), {"warmup_epochs": 1.5}), ((0.02, (10**9,), 0.1, 10**6), {})):
        js, ts = jschedules.multistep_schedule(*args, **kw), tschedules.multistep_schedule(*args, **kw)
        for step in (0, 1, 9, 14, 19, 20, 21, 29, 30, 39, 40, 41, 1000, 2**31 - 2):
            np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6, err_msg=f"{args} {kw} step {step}")
    ts = tschedules.multistep_schedule(0.04, (2, 4), 0.1, 10)
    assert ts(19) == 0.04 and ts(20) == 0.04 * 0.1 and ts(40) == 0.04 * (0.1 * 0.1)


def test_correction_mask_on_the_model():
    """The mask over the port's named parameters is JAX's over the flax
    tree: every conv kernel but the stem's (`layers_0/conv0` included)."""
    with jax.enable_x64(True):
        v = jax.jit(JNet(num_units=(1, 1, 1)).init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    want = flat_names(jcorrection.build_correction_mask(v["params"], exclude=("conv0",)))
    got = tcorrection.build_correction_mask(dict(TNet(num_units=(1, 1, 1)).named_parameters()), exclude=("conv0",))
    assert got == {n: bool(f) for n, f in want.items()}
    assert got["layers_0.conv0.kernel"] and not got["conv0.kernel"] and not got["logit.kernel"]


def _cfgs(batch):
    kw = dict(train_batch_size=batch, bitW=4, abitW=4, admm=True, lr=0.02, momentum=0.9, weight_decay=1e-4,
              lam=1.0, lam2=4.0, admm_mu=0.2, admm_rho=0.3, lr_decay_steps=(1000,), correction_exclude=("conv0",))
    return JConfig(**kw), TConfig(**kw)


def _carry_state(num_units, batch, hw):
    """JAX's init (jitted: its values are carried across, whatever they
    are) in f64, and the port's state built from it."""
    jcfg, tcfg = _cfgs(batch)
    jm = JNet(num_units=num_units, w_bit=4, a_bit=4, admm=True)
    with jax.enable_x64(True):
        js = jax.jit(lambda r: jstate.create_train_state(r, jm, jcfg, input_shape=(1, hw, hw, 3),
                                                          steps_per_epoch=10_000))(jax.random.PRNGKey(0))
        params = jax.tree.map(jnp.asarray, f64_tree(jax.device_get(js.params)))
        js = js.replace(params=params, batch_stats=jax.tree.map(jnp.asarray, f64_tree(jax.device_get(js.batch_stats))),
                        admm_duals=jax.tree.map(lambda a: a.astype(jnp.float64), js.admm_duals),
                        opt_state=js.tx.init(params))
    tm = TNet(num_units=num_units, w_bit=4, a_bit=4, admm=True).double()
    load_flax_preact(tm, jax.device_get(js.params), jax.device_get(js.batch_stats))
    ts = tstate.create_train_state(torch.Generator().manual_seed(0), tm, tcfg, input_shape=(1, hw, hw, 3),
                                   steps_per_epoch=10_000)
    assert sorted(ts.admm_duals) == sorted(js.admm_duals)
    ts.admm_duals = duals_from_jax({k: (np.asarray(s.alter_d), np.asarray(s.gamma))
                                    for k, s in js.admm_duals.items()}, "cpu")
    return (jm, jcfg, js), (tm, tcfg, ts)


def _compare_states(js, ts):
    want = flat_names(jax.device_get(js.params))
    for n, p in ts.params.items():
        np.testing.assert_allclose(p.detach().numpy(), to_port_layout(n, want[n]), **TRAJ_TOL, err_msg=n)
    want = flat_names(jax.device_get(js.batch_stats))
    for n, s in ts.batch_stats.items():
        np.testing.assert_allclose(s.numpy(), want[n], **TRAJ_TOL, err_msg=n)
    for n, s in js.admm_duals.items():
        np.testing.assert_allclose(ts.admm_duals[n].alter_d.numpy(), np.asarray(s.alter_d), **TRAJ_TOL,
                                   err_msg=f"alterD[{n}]")
        np.testing.assert_allclose(ts.admm_duals[n].gamma.numpy(), np.asarray(s.gamma), **TRAJ_TOL,
                                   err_msg=f"gamma[{n}]")


def _run_both(num_units, batch, hw, steps):
    (jm, jcfg, js), (tm, tcfg, ts) = _carry_state(num_units, batch, hw)
    rng = np.random.RandomState(0)
    data = [(rng.randn(batch, hw, hw, 3), rng.randint(0, 10, batch)) for _ in range(steps)]
    jstep, tstep = jsteps.make_train_step(jm, jcfg), tsteps.make_train_step(tm, tcfg)
    with jax.enable_x64(True):
        for x, y in data:
            js, jmet = jstep(js, jnp.asarray(x), jnp.asarray(y))
            ts, tmet = tstep(ts, torch.tensor(x), torch.tensor(y))
            for k in ("loss", "ce", "trans", "accuracy"):
                np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TRAJ_TOL, err_msg=k)
    assert ts.step == steps and ts.tx.count == steps
    _compare_states(js, ts)
    return ts


def test_ten_admm_corrected_steps_match_jax_at_f64():
    ts = _run_both((1, 1, 1), 8, 8, 10)
    assert len(ts.admm_duals) == 9


def test_one_full_depth_resnet20_step_at_f64():
    """ResNet-20 at full depth (9 blocks, 21 ADMM sites), one step. Batch 8
    and 8x8 images: the same op shapes as the 10-step test, whose compiled
    JAX ops this one reuses."""
    ts = _run_both((3, 3, 3), 8, 8, 1)
    assert len(ts.admm_duals) == 21


def test_loader_batches_equal_jax():
    """The same seed gives the same augmented train batches (two epochs)
    and the same test batches as the JAX package's loaders."""
    from alignq_tpu.data import native_augment
    from alignq_tpu.data.registry import get_data as jget
    from alignq_tpu_torch.data.registry import get_data as tget

    jd, td = jget("synthetic", "data", 64, 100, seed=3), tget("synthetic", "data", 64, 100, seed=3)
    assert len(jd.loader_train) == len(td.loader_train) == 32
    exact = not native_augment.available()  # the native kernel folds 1/255 into one multiply-add
    for _ in range(2):
        for (jx, jy), (tx, ty) in zip(jd.loader_train, td.loader_train):
            np.testing.assert_array_equal(ty, jy)
            if exact:
                np.testing.assert_array_equal(tx, jx)
            else:
                np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-5)
    for (jx, jy), (tx, ty) in zip(jd.loader_test, td.loader_test):
        np.testing.assert_array_equal(ty, jy)
        np.testing.assert_allclose(tx, jx, rtol=0, atol=0 if exact else 1e-5)


def test_cifar10_pickles_load_as_jax_loads_them(tmp_path):
    from alignq_tpu.data.datasets import load_cifar10 as jload
    from alignq_tpu_torch.data.datasets import load_cifar10 as tload

    data_dir = write_tiny_cifar10(tmp_path)
    for got, want in zip(tload(data_dir), jload(data_dir)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tload(str(tmp_path / "absent")) is None


def test_checkpoint_round_trip(tmp_path):
    """Save after 2 steps, restore into a fresh state, and the next step of
    both is the same, bit for bit."""
    from alignq_tpu_torch.train.checkpoint import CheckpointManager

    _, tcfg = _cfgs(4)

    def fresh():
        tm = TNet(num_units=(1, 1, 1), w_bit=4, a_bit=4, admm=True, generator=torch.Generator().manual_seed(1))
        return tstate.create_train_state(torch.Generator().manual_seed(2), tm, tcfg, input_shape=(1, 8, 8, 3))

    rng = np.random.RandomState(0)
    data = [(torch.tensor(rng.randn(4, 8, 8, 3), dtype=torch.float32), torch.tensor(rng.randint(0, 10, 4)))
            for _ in range(3)]
    a = fresh()
    step_a = tsteps.make_train_step(a.model, tcfg)
    for x, y in data[:2]:
        step_a(a, x, y)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    mgr.save(1, a, {"top1": 10.0})
    mgr.save(2, a, {"top1": 30.0})
    mgr.save(3, a, {"top1": 20.0})
    assert sorted(p.name for p in (tmp_path / "checkpoint").glob("*.pt")) == ["epoch_2.pt", "epoch_3.pt"]
    b = fresh()
    b, epoch = mgr.restore(b)
    assert epoch == 3 and b.step == 2 and b.tx.count == 2
    step_b = tsteps.make_train_step(b.model, tcfg)
    step_a(a, *data[2])
    step_b(b, *data[2])
    for n, p in a.params.items():
        assert torch.equal(p, b.params[n]), n
    for n, s in a.batch_stats.items():
        assert torch.equal(s, b.batch_stats[n]), n
    for n, s in a.admm_duals.items():
        assert torch.equal(s.gamma, b.admm_duals[n].gamma) and torch.equal(s.alter_d, b.admm_duals[n].alter_d)


def test_cli_trains_on_the_cpu(tmp_path):
    from alignq_tpu_torch.train import cli

    job = tmp_path / "job"
    data_dir = write_tiny_cifar10(tmp_path / "data")
    result = cli.main(["--device", "cpu", "--dataset", "cifar10", "--data_dir", data_dir, "--max_steps", "3",
                       "--num_epochs", "1", "--train_batch_size", "8", "--eval_batch_size", "32", "--bitW", "8",
                       "--abitW", "8", "--variant", "int8", "--deploy_exact", "--cdf_impl", "poly", "--admm",
                       "--job_dir", str(job), "--print_freq", "1"])
    state = result["state"]
    assert state.step == 3 and len(state.admm_duals) == 21
    assert 0 <= result["best_top1"] <= 100
    lines = (job / "run" / "train.jsonl").read_text().splitlines()
    assert len(lines) == 3
    assert (job / "checkpoint" / "epoch_1.pt").is_file() and (job / "config.json").is_file()


def test_entry_points_default_to_the_card():
    """Without a card the trainer raises unless given device='cpu'; a mesh
    that the world does not cover raises, and a 'model' axis takes gather
    mode only (JAX's refusal of 'local')."""
    from alignq_tpu_torch.data.registry import get_data
    from alignq_tpu_torch.train.loop import fit

    cfg = TConfig(train_batch_size=8, eval_batch_size=8, num_epochs=1)
    data = get_data("synthetic", "data", 8, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fit(cfg, data, max_steps=1)
    with pytest.raises(ValueError, match="does not cover"):
        fit(TConfig(mesh_shape=(2,)), data, device="cpu")
    from alignq_tpu_torch.dist.mesh import Mesh

    mesh = Mesh(("data", "model"), (1, 2), None, 0)
    with pytest.raises(ValueError, match="tensor-parallel"):
        tsteps.make_train_step(TNet(num_units=(1, 1, 1)), TConfig(corr_mode="local"), mesh=mesh)
    assert callable(tsteps.make_train_step(TNet(num_units=(1, 1, 1)), cfg, mesh=mesh))
