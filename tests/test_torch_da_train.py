"""The domain-adaptation loops, CLI and export of alignq_tpu_torch on the
CPU (the smoke tests of tests/test_da.py, and the entry points):

- fit_dann (the digit net), fit_dsan and fit_mdd (ResNet-18 at 32x32) run
  max_steps=2 on the synthetic digit domains and report a finite best
  target top-1; the digit DANN's source loss falls over six steps;
- train.cli_da runs each task (--device cpu), refuses a mesh of more than
  one device, and without --device asks for the CUDA card;
- export_da_int8 --task digit trains, reports the INT and fake-quant
  top-1s, the agreement and the margins, and saves an artifact that
  engine_from_artifact serves as the INT graph answers.
"""

import math

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)

from alignq_tpu_torch import export_da_int8
from alignq_tpu_torch.data.digits import get_digit_domain
from alignq_tpu_torch.models import DSAN, MDDNet, MNISTModelQuant
from alignq_tpu_torch.serve import engine_from_artifact
from alignq_tpu_torch.train import cli_da
from alignq_tpu_torch.train import da as TDA
from alignq_tpu_torch.train.state import TrainState

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _digit_loaders(img, bs=8, eval_bs=64):
    """The synthetic digit pair; large eval batches (each eval forward of a
    quantized net requantizes its weights)."""
    return {key: get_digit_domain(dom, "/nonexistent", bs if train else eval_bs, train=train, img_size=img)
            for key, dom, train in (("src_train", "mnist", True), ("tgt_train", "mnistm", True),
                                    ("src_test", "mnist", False), ("tgt_test", "mnistm", False))}


@pytest.mark.parametrize("fit", ["dann", "dsan", "mdd"])
def test_fit_loops_smoke(tmp_path, fit):
    img = 28 if fit == "dann" else 32
    cfg = TDA.DAConfig(train_batch_size=8, eval_batch_size=8, bitW=4, abitW=4, num_classes=10, num_epochs=1,
                       job_dir=str(tmp_path), correction_exclude=(), admm=fit != "dsan")
    gen = torch.Generator().manual_seed(0)
    model = {"dann": lambda: MNISTModelQuant(4, 4, admm=True, generator=gen),
             "dsan": lambda: DSAN("resnet18", 10, w_bit=4, a_bit=4, generator=gen),
             "mdd": lambda: MDDNet("resnet18", 10, 32, 32, w_bit=4, a_bit=4, admm=True, generator=gen)}[fit]()
    loaders = _digit_loaders(img)
    result = getattr(TDA, f"fit_{fit}")(cfg, loaders, model, max_steps=2, device="cpu")
    assert math.isfinite(result["best_tgt_top1"]) and result["state"].step == 2
    assert len(result["state"].admm_duals) == {"dann": 2, "dsan": 0, "mdd": 8}[fit]
    assert (tmp_path / "config.json").exists()


def test_digit_dann_step_lowers_the_source_loss():
    cfg = TDA.DAConfig(train_batch_size=8, bitW=4, abitW=4, num_classes=10, correction_exclude=(), lr=0.01)
    model = MNISTModelQuant(4, 4, generator=torch.Generator().manual_seed(0))
    state = TrainState(0, model, TDA.make_da_optimizer(cfg, dict(model.named_parameters()), 10, TDA.DANN_HEADS), {})
    step = TDA.make_dann_train_step(model, cfg)
    g = torch.Generator().manual_seed(1)
    xs, xt = torch.randn(8, 28, 28, 3, generator=g), torch.randn(8, 28, 28, 3, generator=g) + 0.5
    ys = torch.randint(0, 10, (8,), generator=g)
    losses = [float(step(state, xs, ys, xt, 0.1)[1]["src_class"]) for _ in range(6)]
    assert losses[-1] < losses[0]
    assert set(step(state, xs, ys, xt, 0.1)[1]) == {"loss", "src_class", "src_domain", "tgt_domain", "trans",
                                                    "accuracy"}


@pytest.mark.parametrize("task", ["digit", "dann", "dsan", "mdd"])
def test_cli_da_runs_each_task(tmp_path, task):
    args = ["--task", task, "--device", "cpu", "--max_steps", "1", "--num_epochs", "1", "--bitW", "4", "--abitW", "4",
            "--job_dir", str(tmp_path), "--data_dir", str(tmp_path / "none")]
    if task == "digit":
        args += ["--train_batch_size", "16", "--eval_batch_size", "64", "--admm"]
    else:
        args += ["--arch", "resnet18", "--image_size", "32", "--train_batch_size", "4", "--eval_batch_size", "64"]
    result = cli_da.main(args)
    assert math.isfinite(result["best_tgt_top1"]) and result["state"].step == 1
    assert str(next(result["state"].model.parameters()).device) == "cpu"


def test_cli_da_refuses_meshes_and_asks_for_the_card(tmp_path):
    with pytest.raises(ValueError, match="does not cover"):
        cli_da.main(["--task", "digit", "--device", "cpu", "--mesh", "2", "--job_dir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_da.main(["--task", "digit", "--max_steps", "1", "--job_dir", str(tmp_path)])


def test_export_da_int8_reports_and_saves(tmp_path):
    path = tmp_path / "digit.npz"
    rep = export_da_int8.main(["--task", "digit", "--device", "cpu", "--epochs", "1", "--max_steps", "4", "--batch",
                               "32", "--job_dir", str(tmp_path / "job"), "--save", str(path), "--data_dir",
                               str(tmp_path / "none")])
    for k in ("fq_top1", "int_top1", "delta", "agreement", "disagree_margins", "median_margin", "max_logit_gap"):
        assert k in rep, k
    assert 0 <= rep["agreement"] <= 100 and rep["state"].step == 4
    meta = rep["meta"]
    assert meta["model"] == "digit_dann" and meta["img_size"] == 28
    engine = engine_from_artifact(str(path), batch_size=8, device="cpu")
    try:
        shape = engine.input_shape
        x = np.random.RandomState(0).uniform(-1, 1, (8, *shape)).astype(np.float32)
        got = engine.submit(x).result(timeout=300)
    finally:
        engine.close()
    from alignq_tpu_torch.kernels.deploy_registry import DEPLOY_FAMILIES

    want = DEPLOY_FAMILIES[meta["model"]].forward(meta)(rep["qparams"], torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
