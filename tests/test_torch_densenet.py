"""The port's QAT DenseNet (alignq_tpu_torch/models/densenet.py) against
flax's (alignq_tpu/models/densenet.py), and its structure.

- A depth-10 DenseNet (stem, 3 stages of 2 pre-act blocks, 2
  transitions) on 8x8 images at batch 4, W8A8, the int8 grid, deploy_exact,
  ADMM, with the f32 stage buffer and with the int8 one (stage_int8) under
  each calibrator, at f64: flax's tree (numpy draws, non-trivial BatchNorm
  statistics and StageRequant amax) carried across by interop. The eval
  logits, the train logits and loss, every site's D, every parameter
  gradient, the new BatchNorm statistics and amax agree within 1e-10
  absolute and relative (conv summation order only). JAX runs jitted:
  DenseNet has no residual add whose exact-zero tie XLA's contraction of
  multiply-adds could move (tests/test_torch_qat_model.py).
- The trained model's deploy_tree folds with the port's
  convert_densenet40 into what JAX's converter gives on the same tree
  (weight codes within tests/test_torch_convert.py's tolerance).
- The cases of tests/test_models_extra.py: DenseNet-40's structure and
  forward, its 39 ADMM sites.
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
    random_densenet_tree,
)

from alignq_tpu.kernels import infer_densenet as JD
from alignq_tpu.models.densenet import DenseNet as JNet
from alignq_tpu_torch.interop import deploy_tree, load_flax_tree
from alignq_tpu_torch.kernels import infer_densenet as TD
from alignq_tpu_torch.models.densenet import DenseNet as TNet
from alignq_tpu_torch.models.densenet import densenet_40_quant
from alignq_tpu_torch.nn.layers import QuantAct
from alignq_tpu_torch.train.state import admm_sites

B, HW, DEPTH = 4, 8, 10
TOL = dict(rtol=1e-10, atol=1e-10)
BASE = dict(depth=DEPTH, w_bit=8, a_bit=8, variant="int8", deploy_exact=True, admm=True)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# Under 'max' the batch's largest |value| of a channel whose statistic it
# raises sits on the clip bound to within an ulp, where the gradient is 0,
# 1/2 or 1 by the conv's summation order (XLA's and torch's differ): the
# 'max' case starts from statistics above every value of its batch (the
# update itself is held by tests/test_torch_stage_requant.py).
AMAX_SCALE = {"max": 20.0}

CONFIGS = {
    "f32-buffer": {},
    "stage_int8-max": dict(stage_int8=True, stage_calib="max"),
    "stage_int8-ema": dict(stage_int8=True, stage_calib="ema"),
    "stage_int8-ema_p999": dict(stage_int8=True, stage_calib="ema_p999"),
}


def _tree(stage_int8, seed=11):
    """flax's tree of the depth-10 net (its structure checked against
    flax's init), leaves drawn with numpy."""
    params, stats = random_densenet_tree(DEPTH, seed, stage_int8=stage_int8)
    shapes = jax.eval_shape(JNet(**BASE, stage_int8=stage_int8).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, HW, HW, 3)))
    for want, got in ((shapes["params"], params), (shapes["batch_stats"], stats)):
        assert {k: v.shape for k, v in flat_names(jax.tree.map(lambda s: np.zeros(s.shape), want)).items()} == \
            {k: v.shape for k, v in flat_names(got).items()}
    return params, stats


@pytest.mark.parametrize("name", CONFIGS)
def test_densenet_matches_flax_at_f64(name):
    kw = {**BASE, **CONFIGS[name]}
    params, stats = (f64_tree(t) for t in _tree(kw.get("stage_int8", False)))
    scale = AMAX_SCALE.get(kw.get("stage_calib"), 1.0)
    stats = jax.tree_util.tree_map_with_path(lambda p, v: v * scale if p[-1].key == "amax" else v, stats)
    rng = np.random.RandomState(1)
    x, y = rng.randn(B, HW, HW, 3), rng.randint(0, 10, B)
    with jax.enable_x64(True):
        jm = JNet(**kw)
        want = flax_train_step(jm, params, stats, x, y, jit=True)
        eval_logits = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(
            {"params": params, "batch_stats": stats}, jnp.asarray(x)))

    tm = TNet(**kw).double()
    load_flax_tree(tm, params, stats)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.tensor(x), train=False).numpy(), eval_logits, **TOL)
    got = port_train_step(tm, x, y)
    assert len(got[3]) == 9  # 6 blocks, 2 transitions, the final act site
    assert_train_step_matches(want, got, tm, TOL)
    if kw.get("stage_int8"):
        amax = {n: s.numpy() for n, s in tm.named_buffers() if n.endswith("amax")}
        assert len(amax) == 9 and all((a > 0).all() for a in amax.values())


@pytest.mark.parametrize("stage_int8", [False, True])
def test_deploy_tree_folds_as_jax(stage_int8):
    """The port's trained model (one f32 train forward updates its
    statistics), through deploy_tree and the port's converter, against
    JAX's converter on the same tree."""
    params, stats = _tree(stage_int8, seed=12)
    tm = TNet(**BASE, stage_int8=stage_int8, stage_calib="ema")
    load_flax_tree(tm, params, stats)
    with torch.no_grad():
        tm(torch.tensor(np.random.RandomState(2).randn(B, HW, HW, 3), dtype=torch.float32), train=True)
    tp, ts = deploy_tree(tm)
    tq = TD.convert_densenet40(tp, ts, stage_int8=stage_int8)
    jq = jax.jit(lambda p, s: JD.convert_densenet40(p, s, stage_int8=stage_int8))(
        *jax.tree.map(lambda t: t.numpy(), (tp, ts)))
    assert_qparams_match(jq, tq)
    # the round trip: deploy_tree gives back what was loaded, but the statistics
    flat_p = flat_names(tp)
    for n, v in flat_names(params).items():
        np.testing.assert_array_equal(flat_p[n], v, err_msg=n)


def test_densenet40_forward_and_structure():
    model = densenet_40_quant(bitW=4, abitW=4, method="ours", generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits = model(torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(0)), train=False)
    assert logits.shape == (2, 10) and torch.isfinite(logits).all()
    names = [n for n, _ in model.named_children()]
    assert sum(n.startswith("dense") for n in names) == 36  # 12 a stage, depth 40
    assert "trans1" in names and "trans2" in names
    # buffers 168, 312 and 456 wide (compression 1): the head takes 456
    assert tuple(model.fc.kernel.shape) == (456, 10)
    assert model.trans1.conv1.kernel.shape[:2] == (168, 168) and model.trans2.conv1.kernel.shape[:2] == (312, 312)


def test_densenet40_admm_sites():
    model = densenet_40_quant(bitW=4, abitW=4, method="ours", admm=True)
    sites = admm_sites(model, 4, (1, 32, 32, 3))
    assert len(sites) == 39  # 36 dense blocks, 2 transitions, the final act_q0
    assert sites == sorted(m.site for m in model.modules() if isinstance(m, QuantAct))
    assert "dense3_11/act_q0/d" in sites and "trans2/act_q0/d" in sites


def test_he_fan_out_init():
    """The reference's normal(0, sqrt(2 / (k * k * out))) conv init."""
    model = densenet_40_quant(generator=torch.Generator().manual_seed(0))
    k = model.dense3_11.conv1.kernel.detach()
    assert abs(float(k.std()) - np.sqrt(2.0 / (9 * 12))) < 0.01 * np.sqrt(2.0 / (9 * 12)) * 10
    assert abs(float(k.mean())) < 0.02
