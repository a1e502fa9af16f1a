"""QAT -> INT export of DenseNet and MobileNet-V2 on the CPU
(alignq_tpu_torch/export_int8.py over kernels/deploy_registry.py), the
artifact it saves served by serve.engine_from_artifact, the export CLI's
refusals, and the SVHN reader and loaders (data/datasets.py load_svhn,
data/registry.py) against the JAX package's.

A depth-10 DenseNet (both stage buffers) on 8x8 images and MobileNet-V2
on 16x16 images train a few steps through fit (max_steps) on the
synthetic set; what the engine serves from the saved artifact at its
32x32 request shape equals, bit for bit, the INT forward the export ran.
"""

import logging

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401

from alignq_tpu_torch import export_int8
from alignq_tpu_torch.data import datasets
from alignq_tpu_torch.data.augment import normalize
from alignq_tpu_torch.data.loader import ArrayLoader, Data
from alignq_tpu_torch.kernels.artifact import save_int8_artifact
from alignq_tpu_torch.kernels.deploy_registry import DEPLOY_FAMILIES
from alignq_tpu_torch.models.densenet import DenseNet
from alignq_tpu_torch.models.mobilenetv2 import mobile_v2
from alignq_tpu_torch.serve import engine_from_artifact
from alignq_tpu_torch.train.config import TrainConfig
from alignq_tpu_torch.train.loop import fit

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _data(hw):
    tx, ty, ex, ey = datasets.synthetic(n_train=64, n_test=32, shape=(hw, hw, 3))
    m, s = datasets.CIFAR10_MEAN, datasets.CIFAR10_STD
    return Data(ArrayLoader(tx, ty, 8, shuffle=True, transform_fn=lambda b: normalize(b, m, s), prefetch=0),
                ArrayLoader(ex, ey, 16, transform_fn=lambda b: normalize(b, m, s), prefetch=0))


CASES = {
    "densenet10-f32-buffer": ("densenet40", 8, dict(target_model="densenet_40_quant")),
    "densenet10-stage_int8": ("densenet40", 8, dict(target_model="densenet_40_quant", stage_int8=True)),
    "mobilenetv2": ("mobilenetv2", 16, dict(target_model="mobile_v2")),
}


@pytest.mark.parametrize("case", CASES)
def test_export_and_serve_on_the_cpu(case, tmp_path):
    family, hw, kw = CASES[case]
    cfg = TrainConfig(train_batch_size=8, eval_batch_size=16, num_epochs=1, variant="int8", deploy_exact=True,
                      admm=True, correction_exclude=(), lr=0.01, job_dir=str(tmp_path / "job"), **kw)
    gen = torch.Generator().manual_seed(3)
    if family == "densenet40":
        model = DenseNet(depth=10, variant="int8", deploy_exact=True, admm=True, stage_int8=cfg.stage_int8,
                         stage_calib=cfg.stage_calib, generator=gen)
    else:
        model = mobile_v2(variant="int8", deploy_exact=True, admm=True, generator=gen)
    data = _data(hw)
    result = fit(cfg, data, model=model, max_steps=3, device="cpu")
    assert result["state"].step == 3 and "aborted" not in result
    meta = {"model": family, "act_bits": 8, "weight_bits": 8, "act_impl": "erf", "stream": "int16",
            "stage_int8": int(cfg.stage_int8), "use_stage_kernel": 0}
    if family == "densenet40":
        meta["depth"] = 10
    report, qparams = export_int8.export_and_compare(result["state"].model, data.loader_test, family, meta)
    assert set(report) == {"fq_top1", "int_top1", "delta", "agreement", "disagree_margins", "median_margin",
                           "max_logit_gap", "median_logit_gap"}
    assert 0 <= report["agreement"] <= 100 and report["median_margin"] >= 0
    assert 0 <= report["median_logit_gap"] <= report["max_logit_gap"]
    assert len(report["disagree_margins"]) == round((100 - report["agreement"]) * 32 / 100)  # of 32 images
    assert all(f >= 0 and i >= 0 for f, i in report["disagree_margins"])
    if cfg.stage_int8:
        assert all(float(b["out_scale"].min()) > 1e-6 / 127 for s in qparams["stages"] for b in s["blocks"])
    path = tmp_path / "net.npz"
    save_int8_artifact(str(path), qparams, meta=meta)
    engine = engine_from_artifact(str(path), batch_size=4, device="cpu")
    try:
        x = np.random.RandomState(4).randn(3, 32, 32, 3).astype(np.float32)
        served = engine.submit(x).result(timeout=120)
    finally:
        engine.close()
    fam = DEPLOY_FAMILIES[family]
    want = fam.forward(meta)(qparams, torch.from_numpy(np.concatenate([x, np.zeros((1, 32, 32, 3), np.float32)])),
                             operands=fam.operands(qparams, meta)).numpy()[:3]
    np.testing.assert_array_equal(served, want)


@pytest.mark.parametrize("argv", [
    ["--model", "mobilenetv2", "--stage_int8"],
    ["--model", "resnet20", "--stage_int8"],
    ["--model", "densenet40", "--stage_kernel", "--cdf_impl", "poly"],
    ["--model", "mobilenetv2", "--stream", "int8", "--deploy_exact"],
    ["--model", "densenet40", "--bits", "4", "--pack_int4"],
    ["--model", "mobilenetv2", "--bits", "4", "--deploy_act_impl", "bins_int"],
    ["--model", "vgg16"],
])
def test_cli_refuses_invalid_pairings(argv):
    with pytest.raises(SystemExit):
        export_int8.main(["--device", "cpu"] + argv)


def _write_svhn(data_dir, seed=0):
    """train_32x32.mat and test_32x32.mat as SVHN ships them: X (32, 32,
    3, N) uint8, y (N, 1) with 10 for the digit 0."""
    from scipy.io import savemat

    rng = np.random.RandomState(seed)
    for name, n in (("train_32x32.mat", 24), ("test_32x32.mat", 12)):
        savemat(str(data_dir / name), {"X": rng.randint(0, 256, (32, 32, 3, n)).astype(np.uint8),
                                       "y": rng.randint(1, 11, (n, 1)).astype(np.uint8)})
    return str(data_dir)


def test_svhn_reads_and_loads_as_jax(tmp_path):
    from alignq_tpu.data import datasets as jds
    from alignq_tpu.data import native_augment
    from alignq_tpu.data.registry import get_data as jget
    from alignq_tpu_torch.data.registry import get_data as tget

    data_dir = _write_svhn(tmp_path)
    got, want = datasets.load_svhn(data_dir), jds.load_svhn(data_dir)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].min() >= 0 and got[1].max() <= 9 and got[0].shape == (24, 32, 32, 3)
    jd, td = jget("svhn", data_dir, 8, 4, seed=1), tget("svhn", data_dir, 8, 4, seed=1)
    exact = not native_augment.available()  # the native kernel folds 1/255 into one multiply-add
    for jl, tl in ((jd.loader_train, td.loader_train), (jd.loader_test, td.loader_test)):
        assert len(jl) == len(tl)
        for (jx, jy), (tx, ty) in zip(jl, tl):  # normalize only: no crop, no flip
            np.testing.assert_array_equal(ty, jy)
            np.testing.assert_allclose(tx, jx, rtol=0, atol=0 if exact else 1e-5)


def test_svhn_falls_back_to_synthetic(tmp_path, caplog):
    from alignq_tpu_torch.data.registry import get_data

    with caplog.at_level(logging.WARNING):
        data = get_data("svhn", str(tmp_path), 64, 64)
    assert "svhn not found" in caplog.text
    xb, _ = next(iter(data.loader_test))
    want = normalize(datasets.synthetic()[2][:64], datasets.SVHN_MEAN, datasets.SVHN_STD)
    np.testing.assert_array_equal(xb, want)
    with pytest.raises(ValueError, match="unknown dataset"):
        get_data("imagenet", str(tmp_path), 8, 8)


def test_export_cli_mxu_bf16_exports_the_f32_forward(tmp_path):
    """--mxu_bf16 trains with bf16 convs; the agreement and the export run
    the f32 twin on the trained weights."""
    from torch_port_helpers import write_tiny_cifar10

    out = export_int8.main(["--device", "cpu", "--model", "resnet20", "--mxu_bf16", "--dataset", "cifar10",
                            "--data_dir", write_tiny_cifar10(tmp_path / "data", n_test=16), "--epochs", "1",
                            "--batch", "8", "--job_dir", str(tmp_path / "job")])
    assert all(m.mxu_dtype is None for m in out["model"].modules() if hasattr(m, "mxu_dtype"))
    assert any(m.mxu_dtype is torch.bfloat16 for m in out["state"].model.modules() if hasattr(m, "mxu_dtype"))
    for name, p in out["model"].named_parameters():
        assert torch.equal(p, out["state"].params[name]), name
    assert out["meta"]["model"] == "resnet20" and out["state"].step == 10
