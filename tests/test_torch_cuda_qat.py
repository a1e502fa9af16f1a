"""The port's QAT half on the card: train steps against the CPU, a
trained net exported through K1 and K3, a trained DenseNet (both stage
buffers) and MobileNet-V2 exported and served through K1, the BN-act
kernels and the depthwise kernel, and the training CLI's runs repeated
under cudnn.deterministic.

Needs a CUDA card: every test takes the `cuda` fixture, which skips
without one. Imports no JAX:

    python -m pytest tests/test_torch_cuda_qat.py -q --noconftest
"""

import json

import numpy as np
import pytest
import torch

from alignq_tpu_torch.interop import deploy_tree
from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels import dwconv as DWm
from alignq_tpu_torch.kernels import infer_densenet as TD
from alignq_tpu_torch.kernels import infer_mobilenet as TM
from alignq_tpu_torch.kernels import qmatmul as K1
from alignq_tpu_torch.kernels import quantize as K2
from alignq_tpu_torch.kernels import stage_kernel as K3
from alignq_tpu_torch.kernels.artifact import load_int8_artifact, save_int8_artifact
from alignq_tpu_torch.kernels.deploy_registry import DEPLOY_FAMILIES
from alignq_tpu_torch.kernels.infer import convert_preact_resnet, resnet20_int8_stream
from alignq_tpu_torch.models.densenet import DenseNet
from alignq_tpu_torch.models.mobilenetv2 import mobile_v2
from alignq_tpu_torch.models.resnet_cifar import PreActResNet
from alignq_tpu_torch.nn.layers import StageRequant
from alignq_tpu_torch.serve import engine_from_artifact
from alignq_tpu_torch.train import TrainConfig, create_train_state, make_train_step
from alignq_tpu_torch.train.loop import true_f32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    true_f32()
    return torch.device("cuda")


def _train(where, dtype, steps, build=None, hw=16, **kw):
    """`steps` train steps at batch 8 on hw x hw images of a PreActResNet
    num_units=(1, 1, 1) with the options kw, or of build(generator)."""
    cfg = TrainConfig(train_batch_size=8, lr=0.02, lr_decay_steps=(1000,),
                      correction_exclude=() if build else ("conv0",),
                      **{k: v for k, v in kw.items() if k in ("bitW", "abitW", "admm")})
    model_kw = dict(w_bit=kw.get("bitW", 8), a_bit=kw.get("abitW", 8), admm=kw.get("admm", False),
                    **{k: v for k, v in kw.items() if k in ("variant", "deploy_exact", "cdf_impl")})
    gen = torch.Generator().manual_seed(0)
    model = build(gen) if build else PreActResNet(num_units=(1, 1, 1), generator=gen, **model_kw)
    model = model.to(dtype).to(where)
    state = create_train_state(gen, model, cfg, input_shape=(1, hw, hw, 3), steps_per_epoch=10_000)
    step = make_train_step(model, cfg)
    rng = np.random.RandomState(0)
    for _ in range(steps):
        x = torch.tensor(rng.randn(8, hw, hw, 3), dtype=dtype).to(where)
        step(state, x, torch.tensor(rng.randint(0, 10, 8)).to(where))
    return state


def test_f64_steps_on_the_card_equal_the_cpu(cuda):
    """Params, BatchNorm statistics and duals within 1e-9 after 3 steps."""
    kw = dict(bitW=4, abitW=4, admm=True)
    cpu, card = _train("cpu", torch.float64, 3, **kw), _train(cuda, torch.float64, 3, **kw)
    for table in ("params", "batch_stats"):
        for k, v in getattr(cpu, table).items():
            torch.testing.assert_close(getattr(card, table)[k].detach().cpu(), v.detach(), rtol=0, atol=1e-9)
    for k, s in cpu.admm_duals.items():
        torch.testing.assert_close(card.admm_duals[k].gamma.cpu(), s.gamma, rtol=0, atol=1e-9)


def test_trained_net_exports_through_k1_and_k3(cuda):
    """A deploy-exact poly net trained on the card, folded on the card:
    its INT stream through K1 (poly codes) and K3 equals the CPU plain
    path's on the same qparams."""
    state = _train(cuda, torch.float32, 2, bitW=8, abitW=8, variant="int8", deploy_exact=True, cdf_impl="poly")
    qp = convert_preact_resnet(*deploy_tree(state.model))
    qp_cpu = {**qp, "conv0": type(qp["conv0"])(*(t.cpu() for t in qp["conv0"])),
              "layers": [{k: (type(v)(*(t.cpu() for t in v)) if hasattr(v, "_fields") else v) for k, v in b.items()}
                         for b in qp["layers"]],
              "logit": {k: v.cpu() for k, v in qp["logit"].items()}}
    x = torch.randn((8, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    kw = dict(act_impl="poly", use_stage_kernel=True, use_pallas_1x1=True)
    before = dict(_build.launches)
    got = resnet20_int8_stream(qp, x.to(cuda), **kw)
    torch.cuda.synchronize()
    counts = {k: _build.launches[k] - before.get(k, 0) for k in (K1.KERNEL, K1.MODE.format("poly"), K3.KERNEL)}
    assert counts[K1.KERNEL] > 0 and counts[K1.MODE.format("poly")] == counts[K1.KERNEL] and counts[K3.KERNEL] > 0
    assert torch.equal(got.cpu(), resnet20_int8_stream(qp_cpu, x, **kw))


FAMILIES = {
    "densenet10-stage_int8-ema": lambda g: DenseNet(depth=10, variant="int8", deploy_exact=True, stage_int8=True,
                                                    stage_calib="ema", admm=True, generator=g),
    "densenet10-f32-buffer": lambda g: DenseNet(depth=10, variant="int8", deploy_exact=True, admm=True, generator=g),
    "mobilenetv2": lambda g: mobile_v2(variant="int8", deploy_exact=True, admm=True, generator=g),
}


def _w4a4(name):
    """The family at W4A4, as the ResNet case above. At W8A8 the
    correction's bin phase (255 bins, a sawtooth of slope 2040 in the
    weight's CDF) grows a difference in the conv's summation order by
    orders of magnitude a step, on the CPU alone too, past 1e-9 in 3 steps
    of MobileNet-V2. The int8 buffer's statistics start uniform in [2, 6],
    a calibrated net's scale: ema's first update would seed them with the
    batch's max, which then sits on the clip bound to within an ulp, where
    the gradient is 0, 1/2 or 1."""
    q = dict(variant="int8", deploy_exact=True, admm=True)
    if name.startswith("mobilenet"):
        return lambda g: mobile_v2(bitW=4, abitW=4, generator=g, **q)

    def build(g):
        model = DenseNet(depth=10, w_bit=4, a_bit=4, stage_int8="stage_int8" in name, stage_calib="ema",
                         generator=g, **q)
        for m in model.modules():
            if isinstance(m, StageRequant):
                m.amax.uniform_(2.0, 6.0, generator=g)
        return model

    return build


@pytest.mark.parametrize("name", FAMILIES)
def test_family_f64_steps_on_the_card_equal_the_cpu(cuda, name):
    """Params, BatchNorm statistics, StageRequant amax and duals within
    1e-9 after 3 W4A4 steps with ADMM and the correction."""
    cpu = _train("cpu", torch.float64, 3, _w4a4(name), bitW=4, abitW=4, admm=True)
    card = _train(cuda, torch.float64, 3, _w4a4(name), bitW=4, abitW=4, admm=True)
    for table in ("params", "batch_stats"):
        for k, v in getattr(cpu, table).items():
            torch.testing.assert_close(getattr(card, table)[k].detach().cpu(), v.detach(), rtol=0, atol=1e-9)
    assert cpu.admm_duals
    for k, s in cpu.admm_duals.items():
        torch.testing.assert_close(card.admm_duals[k].gamma.cpu(), s.gamma, rtol=0, atol=1e-9)
        torch.testing.assert_close(card.admm_duals[k].alter_d.cpu(), s.alter_d, rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", FAMILIES)
def test_trained_family_net_serves_through_the_kernels(cuda, name, tmp_path):
    """A net trained 2 steps on the card, exported on the card and saved;
    served from its artifact on the card: its final stage buffer or block
    stream equals the CPU plain path's on the same qparams, through K1 and
    the BN-act table (int8 buffer), the BN-act arithmetic (f32 buffer) or
    the depthwise kernel, with no tap gathered."""
    family = "mobilenetv2" if name.startswith("mobilenet") else "densenet40"
    state = _train(cuda, torch.float32, 2, FAMILIES[name], admm=True)
    meta = {"model": family, "act_bits": 8, "weight_bits": 8, "act_impl": "erf", "stream": "int16",
            "stage_int8": int("stage_int8" in name), "use_stage_kernel": 0}
    if family == "densenet40":
        meta["depth"] = 10
    fam = DEPLOY_FAMILIES[family]
    qp = fam.convert(*deploy_tree(state.model), meta)
    path = tmp_path / "net.npz"
    save_int8_artifact(str(path), qp, meta=meta)
    before = dict(_build.launches)
    engine = engine_from_artifact(str(path), batch_size=8, device=cuda)
    x = torch.randn((8, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    try:
        served = engine.submit(x.numpy()).result(timeout=300)
    finally:
        engine.close()
    torch.cuda.synchronize()
    counts = {k: _build.launches[k] - before.get(k, 0) for k in (K1.KERNEL, K1.TAP_GATHERS, DWm.DW, K2.BN_ACT_TABLE,
                                                                 K2.BN_ACT_ARITH)}
    streams = TM.mobilenetv2_int8_streams if family == "mobilenetv2" else TD.densenet40_int8_buffers
    kw = {"stage_int8": True} if meta["stage_int8"] else {}
    got = list(streams(engine.params, x.to(cuda), operands=engine.forward.keywords["operands"], **kw))[-1]
    qp_cpu = load_int8_artifact(str(path), fam.template(meta, "cpu"))[0]
    assert torch.equal(got.cpu(), list(streams(qp_cpu, x, **kw))[-1])
    want = fam.forward(meta)(qp_cpu, x).numpy()
    assert float(abs(served - want).max()) <= 1e-5
    assert counts[K1.KERNEL] > 0 and not counts[K1.TAP_GATHERS]
    if family == "mobilenetv2":
        assert counts[DWm.DW] * 50 == counts[K1.KERNEL] * 17
    elif meta["stage_int8"]:
        assert counts[K2.BN_ACT_TABLE] == counts[K1.KERNEL] and counts[K2.BN_ACT_ARITH] == 9
    else:
        assert counts[K2.BN_ACT_ARITH] == counts[K1.KERNEL] and not counts[K2.BN_ACT_TABLE]


CLI_ARGS = ["--dataset", "synthetic", "--bitW", "8", "--abitW", "8", "--variant", "int8", "--deploy_exact",
            "--cdf_impl", "poly", "--admm", "--train_batch_size", "64", "--eval_batch_size", "64", "--num_epochs", "2",
            "--print_freq", "1"]


def test_cli_runs_repeat_under_cudnn_deterministic(cuda, tmp_path):
    """chip_smoke.py phase 8(b)'s training CLI (ResNet-20 W8A8 int8
    deploy_exact poly ADMM, batch 64, 2 epochs), run three times from one
    seed with cudnn.deterministic set: the same losses and eval top-1 each
    time. Two runs with it unset are printed beside them (pytest -s)."""
    from alignq_tpu_torch.train import cli

    def run(i):
        job = tmp_path / f"job{i}"
        result = cli.main(CLI_ARGS + ["--job_dir", str(job)])
        losses = [json.loads(line)["loss"] for line in (job / "run" / "train.jsonl").read_text().splitlines()]
        return losses, result["best_top1"]

    saved = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = True
        det = [run(i) for i in range(3)]
        torch.backends.cudnn.deterministic = False
        free = [run(3 + i) for i in range(2)]
    finally:
        torch.backends.cudnn.deterministic = saved
    for label, runs in (("cudnn.deterministic", det), ("default", free)):
        for losses, top1 in runs:
            print(f"CLI run ({label}): eval top-1 {top1:.2f}, loss first {losses[0]:.6f} last {losses[-1]:.6f}, "
                  f"{len(losses)} steps")
    print(f"default runs: largest step loss difference {max(abs(a - b) for a, b in zip(free[0][0], free[1][0])):.3g}")
    assert all(len(losses) == 64 for losses, _ in det)
    assert det[1] == det[0] and det[2] == det[0]
