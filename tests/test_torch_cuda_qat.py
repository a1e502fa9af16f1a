"""The port's QAT half on the card: train steps against the CPU, and a
trained net exported through K1 and K3.

Needs a CUDA card: every test takes the `cuda` fixture, which skips
without one. Imports no JAX:

    python -m pytest tests/test_torch_cuda_qat.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from alignq_tpu_torch.interop import deploy_tree
from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels import qmatmul as K1
from alignq_tpu_torch.kernels import stage_kernel as K3
from alignq_tpu_torch.kernels.infer import convert_preact_resnet, resnet20_int8_stream
from alignq_tpu_torch.models.resnet_cifar import PreActResNet
from alignq_tpu_torch.train import TrainConfig, create_train_state, make_train_step
from alignq_tpu_torch.train.loop import true_f32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    true_f32()
    return torch.device("cuda")


def _train(where, dtype, steps, **kw):
    cfg = TrainConfig(train_batch_size=8, lr=0.02, lr_decay_steps=(1000,), **{k: v for k, v in kw.items()
                                                                              if k in ("bitW", "abitW", "admm")})
    model_kw = dict(w_bit=kw.get("bitW", 8), a_bit=kw.get("abitW", 8), admm=kw.get("admm", False),
                    **{k: v for k, v in kw.items() if k in ("variant", "deploy_exact", "cdf_impl")})
    gen = torch.Generator().manual_seed(0)
    model = PreActResNet(num_units=(1, 1, 1), generator=gen, **model_kw).to(dtype).to(where)
    state = create_train_state(gen, model, cfg, input_shape=(1, 16, 16, 3), steps_per_epoch=10_000)
    step = make_train_step(model, cfg)
    rng = np.random.RandomState(0)
    for _ in range(steps):
        x = torch.tensor(rng.randn(8, 16, 16, 3), dtype=dtype).to(where)
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
