"""The port's QAT MobileNet-V2 (alignq_tpu_torch/models/mobilenetv2.py)
against flax's (alignq_tpu/models/mobilenetv2.py), and its structure.

- The full CFG (17 blocks, 67 act sites) on 16x16 images at batch 4,
  W8A8, ADMM, without and with deploy_exact (the int8 grid, the stem's
  S_IMG site and the signed m = 2 block-edge requant), at f64: flax's tree
  (numpy draws, non-trivial BatchNorm statistics) carried across by
  interop, the depthwise kernels HWIO (3, 3, 1, C) -> OIHW (C, 1, 3, 3).
  The eval logits, the train logits and loss, every site's D, every
  parameter gradient and the new BatchNorm statistics agree within 1e-10
  absolute and relative (conv summation order only). JAX runs jitted:
  XLA's contraction of multiply-adds moves a value by an ulp of f64, and
  no relu follows the residual add here, so no exact-zero tie turns on it
  (PreActResNet's does: tests/test_torch_qat_model.py runs eagerly). The
  deploy_exact configuration runs in
  tests/test_torch_mobilenet_deploy_exact.py.
- The trained model's deploy_tree folds with the port's
  convert_mobilenetv2 into what JAX's converter gives on the same tree.
- The cases of tests/test_models_extra.py: the forward, the 17 blocks,
  the depthwise conv2, the stride-1 shortcuts, the 1280-wide head.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (  # noqa: F401
    assert_qparams_match,
    assert_train_step_matches,
    f64_tree,
    flat_names,
    flax_train_step,
    one_torch_thread,
    port_train_step,
    random_mobilenet_tree,
)

from alignq_tpu.kernels import infer_mobilenet as JM
from alignq_tpu.models.mobilenetv2 import MobileNetV2 as JNet
from alignq_tpu_torch.interop import deploy_tree, load_flax_tree
from alignq_tpu_torch.kernels import infer_mobilenet as TM
from alignq_tpu_torch.models.mobilenetv2 import MobileNetV2 as TNet
from alignq_tpu_torch.models.mobilenetv2 import mobile_v2
from alignq_tpu_torch.nn.layers import QuantAct

B, HW = 4, 16
TOL = dict(rtol=1e-10, atol=1e-10)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CONFIGS = {
    "W8A8-admm": dict(w_bit=8, a_bit=8, admm=True),
    "deploy_exact-int8-W8A8-admm": dict(w_bit=8, a_bit=8, admm=True, variant="int8", deploy_exact=True),
}
# the second config runs in tests/test_torch_mobilenet_deploy_exact.py: the
# JAX side's jit takes ~1 minute a config, and each file is one xdist job
OWN = ("W8A8-admm",)


def _tree(seed):
    """flax's tree of MobileNet-V2 (its structure checked against flax's
    init), leaves drawn with numpy."""
    params, stats = random_mobilenet_tree(seed)
    shapes = jax.eval_shape(JNet().init, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
    for want, got in ((shapes["params"], params), (shapes["batch_stats"], stats)):
        assert {k: v.shape for k, v in flat_names(jax.tree.map(lambda s: np.zeros(s.shape), want)).items()} == \
            {k: v.shape for k, v in flat_names(got).items()}
    return params, stats


def check_matches_flax_at_f64(name):
    kw = CONFIGS[name]
    params, stats = (f64_tree(t) for t in _tree(13))
    rng = np.random.RandomState(1)
    x, y = rng.randn(B, HW, HW, 3), rng.randint(0, 10, B)
    with jax.enable_x64(True):
        jm = JNet(**kw)
        want = flax_train_step(jm, params, stats, x, y, jit=True)
        eval_logits = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(
            {"params": params, "batch_stats": stats}, jnp.asarray(x)))

    tm = TNet(**kw).double()
    load_flax_tree(tm, params, stats)
    assert tuple(tm.layers_1.conv2.kernel.shape) == (96, 1, 3, 3)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.tensor(x), train=False).numpy(), eval_logits, **TOL)
    got = port_train_step(tm, x, y)
    assert len(got[3]) == 67  # the stem, 3 a block, 14 shortcuts, the head
    assert_train_step_matches(want, got, tm, TOL)


@pytest.mark.parametrize("name", OWN)
def test_mobilenetv2_matches_flax_at_f64(name):
    check_matches_flax_at_f64(name)


def test_deploy_tree_folds_as_jax():
    params, stats = _tree(14)
    tm = TNet(variant="int8", deploy_exact=True)
    load_flax_tree(tm, params, stats)
    with torch.no_grad():
        tm(torch.tensor(np.random.RandomState(2).randn(B, HW, HW, 3), dtype=torch.float32), train=True)
    tp, ts = deploy_tree(tm)
    assert tuple(tp["layers_1"]["conv2"]["kernel"].shape) == (3, 3, 1, 96)
    tq = TM.convert_mobilenetv2(tp, ts)
    jq = jax.jit(JM.convert_mobilenetv2)(*jax.tree.map(lambda t: t.numpy(), (tp, ts)))
    assert_qparams_match(jq, tq)
    flat_p = flat_names(tp)
    for n, v in flat_names(params).items():
        np.testing.assert_array_equal(flat_p[n], v, err_msg=n)


def test_forward_and_depthwise():
    model = mobile_v2(bitW=4, abitW=4, method="ours", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits = model(torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1)), train=False)
    assert logits.shape == (2, 10) and torch.isfinite(logits).all()
    blocks = [n for n, _ in model.named_children() if n.startswith("layers_")]
    assert len(blocks) == 17  # 1+2+3+4+3+3+1 (mobilenetV2.py:77-83)
    # depthwise conv2: one input channel a group (groups == planes)
    assert model.layers_1.conv2.kernel.shape[1] == 1 and model.layers_1.conv2.groups == 96
    # the quantized 1x1 shortcut exists on stride-1 blocks only
    assert hasattr(model.layers_0, "shortcut_conv") and not hasattr(model.layers_3, "shortcut_conv")
    sites = sorted(m.site for m in model.modules() if isinstance(m, QuantAct))
    assert len(sites) == 67 and "layers_0/act_skip/d" in sites and "act_q2/d" in sites


def test_head_width():
    model = mobile_v2(bitW=8, abitW=8, method="ours")
    assert tuple(model.linear.kernel.shape) == (1280, 10)
    assert tuple(model.conv2.kernel.shape) == (1280, 320, 1, 1)


def test_mxu_bf16_depthwise_convs():
    """mxu_dtype: a grouped conv takes bf16 operands too and gives f32,
    within bf16's rounding of the f32 conv on the same kernel; the model
    threads it to every conv."""
    from alignq_tpu_torch.nn.layers import QConv

    f32 = QConv(96, 96, 3, 1, 1, groups=96, generator=torch.Generator().manual_seed(0))
    bf16 = QConv(96, 96, 3, 1, 1, groups=96, mxu_dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    x = torch.randn((2, 96, 8, 8), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        ref, got = f32(x), bf16(x)
    assert got.dtype == torch.float32 and ref.shape == got.shape == (2, 96, 8, 8)
    assert float((got - ref).abs().max()) <= 2e-2 * float(ref.abs().max())
    model = mobile_v2(mxu_dtype=torch.bfloat16)
    assert all(m.mxu_dtype is torch.bfloat16 for m in model.modules() if isinstance(m, QConv))
