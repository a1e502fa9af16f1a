"""The port's StageRequant (alignq_tpu_torch/nn/layers.py) and its
per-channel requant_ste against the JAX package's, on the same numpy
inputs: the cases of tests/test_stage_int8.py (but the data-parallel pmax
combine, which waits for the port's distribution), each held against
JAX's values, gradients and statistic at f32 and at f64. Both sides do the
same elementwise IEEE operations in the same order, so they are held
equal (JAX runs eagerly). Also the registry's and the config's stage_int8
rules, and the percentile beyond torch.quantile's 2^24-element limit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401

from alignq_tpu.nn.layers import StageRequant as JStage
from alignq_tpu.quant.ste import requant_ste as j_requant_ste
from alignq_tpu.train.config import TrainConfig as JConfig
from alignq_tpu_torch.models.registry import build_model
from alignq_tpu_torch.nn.layers import StageRequant as TStage
from alignq_tpu_torch.nn.layers import _percentile_by_channel
from alignq_tpu_torch.quant.ste import requant_ste as t_requant_ste
from alignq_tpu_torch.train.config import TrainConfig

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}


def _nchw(x):
    return x.transpose(0, 3, 1, 2) if x.ndim == 4 else x


def _nhwc(x):
    return x.transpose(0, 2, 3, 1) if x.ndim == 4 else x


def _run(steps, dtype, calib="max", ema_decay=0.99):
    """Each (x NHWC, train) of steps through JAX's StageRequant and the
    port's, the statistic carried from step to step on each side: per step
    (jax, port) pairs of the value, the gradient of sum(value * w) and the
    statistic after the step. Both sides' pairs are checked equal here."""
    npd, td = DTYPES[dtype]
    c = steps[0][0].shape[-1]
    out = []
    with jax.enable_x64(dtype == "f64"):
        jmod = JStage(calib=calib, ema_decay=ema_decay)
        stats = {"amax": jnp.zeros((c,), npd)}
        tmod = TStage(c, calib=calib, ema_decay=ema_decay).to(td)
        for i, (x, train) in enumerate(steps):
            x = x.astype(npd)
            w = np.random.RandomState(i).rand(*x.shape).astype(npd)

            def f(xx, stats=stats, train=train, w=w):
                if train:
                    y, nv = jmod.apply({"batch_stats": stats}, xx, True, mutable=["batch_stats"])
                    return jnp.sum(y * w), (y, nv["batch_stats"])
                return jnp.sum(jmod.apply({"batch_stats": stats}, xx, False) * w), (None, stats)

            (_, (jy, stats)), jg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
            if jy is None:
                jy = jmod.apply({"batch_stats": stats}, jnp.asarray(x), False)
            xt = torch.tensor(_nchw(x), requires_grad=True)
            ty = tmod(xt, train=train)
            (tg,) = torch.autograd.grad((ty * torch.tensor(_nchw(w))).sum(), xt)
            pairs = [(np.asarray(jy), _nhwc(ty.detach().numpy())), (np.asarray(jg), _nhwc(tg.numpy())),
                     (np.asarray(stats["amax"]), tmod.amax.numpy().copy())]
            for what, (j, t) in zip(("value", "gradient", "amax"), pairs):
                assert j.dtype == t.dtype == npd, what
                np.testing.assert_array_equal(t, j, err_msg=f"step {i} {what}")
            out.append(pairs)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_updates_monotone_channel_max(dtype):
    x1 = np.stack([np.full((4, 4), 2.0), np.full((4, 4), -5.0)], -1)[None]
    res = _run([(x1, True), (0.5 * x1, True), (3.0 * x1, True)], dtype)
    amax = [r[2][1] for r in res]
    np.testing.assert_allclose(amax[0], [2.0, 5.0])
    np.testing.assert_allclose(amax[1], [2.0, 5.0])  # a smaller batch does not shrink it
    np.testing.assert_allclose(amax[2], [6.0, 15.0])  # a larger one grows it


@pytest.mark.parametrize("dtype", DTYPES)
def test_values_on_grid_and_clip(dtype):
    x = np.random.RandomState(1).randn(2, 3, 3, 4) * 3.0
    (value, _, stat), = _run([(x, True)], dtype)
    y, amax = value[1], stat[1]
    codes = y / (np.maximum(amax, 1e-6) * (1.0 / 127))
    np.testing.assert_allclose(codes, np.round(codes), atol=1e-4)
    assert np.abs(codes).max() <= 127 + 1e-4
    # the calibrating batch itself is not clipped: its largest |code| is 127
    assert np.abs(codes).max() >= 126.5


@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_clips_beyond_calibrated_range(dtype):
    x = np.ones((1, 2, 2, 1))
    res = _run([(x, True), (10.0 * x, False)], dtype)  # amax = 1
    np.testing.assert_allclose(res[1][0][1], 1.0, rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ste_gradient_masks_saturation(dtype):
    """Strictly inside the calibrated range the gradient passes; strictly
    beyond it is 0 (at the bound itself both give clip's 1/2 tie)."""
    res = _run([(np.array([[0.5, 2.0]]), True), (np.array([[0.3, 3.0]]), False)], dtype, calib="max")
    w = np.random.RandomState(1).rand(1, 2).astype(DTYPES[dtype][0])
    np.testing.assert_allclose(res[1][1][1], [[w[0, 0], 0.0]], rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ema_decays_outlier(dtype):
    spike, norm = np.full((2, 4, 4, 1), 80.0), np.full((2, 4, 4, 1), 1.0)
    steps = [(spike, True)] + [(norm, True)] * 50
    s_max = _run(steps, dtype, calib="max")[-1][2][1]
    s_ema = _run(steps, dtype, calib="ema", ema_decay=0.9)[-1][2][1]
    assert float(s_max[0]) == 80.0  # permanently inflated
    assert float(s_ema[0]) < 1.5  # decayed back to the signal


@pytest.mark.parametrize("dtype", DTYPES)
def test_ema_p999_ignores_within_batch_outlier(dtype):
    x = np.ones((4, 16, 16, 2))
    x[0, 0, 0, 0] = 1000.0
    x[..., 1] = np.random.RandomState(3).rand(4, 16, 16) * 5  # a channel whose percentile interpolates
    res = _run([(x, True), (0.5 * x, True)], dtype, calib="ema_p999")
    # 1 outlier in 1024 values lies beyond the 99.9th percentile
    assert float(res[0][2][1][0]) < 20.0
    assert 4.9 < float(res[1][2][1][1]) < 5.0


def test_unknown_calib_raises():
    mod = JStage(calib="median")
    x = jnp.ones((1, 2, 2, 1))
    v = mod.init(jax.random.PRNGKey(0), x, train=False)
    with pytest.raises(ValueError, match="calib"):
        mod.apply(v, x, True, mutable=["batch_stats"])
    with pytest.raises(ValueError, match="calib"):
        TStage(1, calib="median")


@pytest.mark.parametrize("dtype", DTYPES)
def test_requant_ste_per_channel_scale(dtype):
    """A (C,) scale broadcasts over the channel axis: JAX's last (NHWC),
    the port's axis 1 (NCHW). Values and gradients equal, values at a
    bound included (clip's 1/2 tie)."""
    npd, td = DTYPES[dtype]
    rng = np.random.RandomState(4)
    scale = (rng.rand(5) * 0.1 + 0.01).astype(npd)
    x = (rng.randn(3, 4, 4, 5) * 6).astype(npd)
    x[0, 0, 0] = 127 * scale  # on the upper bound
    w = rng.rand(*x.shape).astype(npd)
    with jax.enable_x64(dtype == "f64"):
        jy = np.asarray(j_requant_ste(jnp.asarray(x), jnp.asarray(scale), 127))
        jg = np.asarray(jax.grad(lambda v: jnp.sum(j_requant_ste(v, jnp.asarray(scale), 127) * w))(jnp.asarray(x)))
    xt = torch.tensor(_nchw(x), requires_grad=True)
    ty = t_requant_ste(xt, torch.tensor(scale), 127)
    (tg,) = torch.autograd.grad((ty * torch.tensor(_nchw(w))).sum(), xt)
    np.testing.assert_array_equal(_nhwc(ty.detach().numpy()), jy)
    np.testing.assert_array_equal(_nhwc(tg.numpy()), jg)
    assert ty.dtype == td and 0 < float((tg == 0).float().mean()) < 1


def test_percentile_beyond_torch_quantile_limit():
    """One channel of 2^24 + 4.2k elements (torch.quantile refuses over
    2^24): the 99.9th percentile equals jnp.percentile's."""
    x = np.abs(np.random.RandomState(5).randn(1, 1, 4097, 4097)).astype(np.float32)
    want = float(jax.jit(lambda v: jnp.percentile(v, 99.9))(x.reshape(-1)))
    got = _percentile_by_channel(torch.from_numpy(x), 99.9)
    assert got.shape == (1,) and float(got[0]) == want
    with pytest.raises(RuntimeError):
        torch.quantile(torch.from_numpy(x).reshape(-1), 0.999)


def test_registry_and_config_wiring():
    cfg = TrainConfig(target_model="densenet_40_quant", variant="int8", deploy_exact=True, stage_int8=True)
    m = build_model(cfg)
    assert m.stage_int8 and m.deploy_exact
    calibs = {mod.calib for mod in m.modules() if isinstance(mod, TStage)}
    assert calibs == {cfg.stage_calib} == {"ema"} and JConfig().stage_calib == "ema"
    assert sum(isinstance(mod, TStage) for mod in m.modules()) == 1 + 36 + 2
    m = build_model(dataclasses.replace(cfg, stage_calib="ema_p999"))
    assert {mod.calib for mod in m.modules() if isinstance(mod, TStage)} == {"ema_p999"}
    with pytest.raises(ValueError):
        build_model(dataclasses.replace(cfg, deploy_exact=False))
    with pytest.raises(ValueError):
        build_model(dataclasses.replace(cfg, target_model="resnet20_quant"))
    with pytest.raises(ValueError):
        build_model(dataclasses.replace(cfg, target_model="mobile_v2"))
    with pytest.raises(ValueError):
        build_model(dataclasses.replace(cfg, stage_int8=False, stream_int8=True))
    # deploy_exact serves every family; stage_int8 off leaves no site
    for name in ("resnet20_quant", "resnet56_quant", "densenet_40_quant", "mobile_v2"):
        m = build_model(TrainConfig(target_model=name, variant="int8", deploy_exact=True))
        assert m.deploy_exact and not any(isinstance(mod, TStage) for mod in m.modules())
