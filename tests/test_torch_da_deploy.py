"""The domain-adaptation INT8 serving graphs of alignq_tpu_torch on the
CPU, against the JAX package: the digit DANN (kernels/infer_digit.py) and
the DANN, DSAN and MDD heads on the ImageNet-layout trunk
(kernels/infer_resnet_imagenet.py), their deploy families and K1's 5x5
VALID form.

- convert_dann, convert_dsan, convert_mdd and convert_mnist_dann equal
  JAX's leaf for leaf (assert_qparams_match: weight codes within one code
  on under 1e-3 of them, f32 leaves within an f32 rounding);
- the digit graph: both convs' pooled relu'd codes bit-identical to
  jitted JAX's, for erf and poly and for a 1-channel image; class and
  domain logits within 1e-5 relative of jax.jit(mnist_dann_int8_forward);
- the DA trunk forwards: every stage's codes and stream of the trunk
  bit-identical to jitted JAX's (test_torch_resnet_imagenet._jax_stages),
  the logits within 1e-5 relative of the jitted forward;
- JAX-saved dann, dsan, mdd and digit_dann artifacts served by the port's
  engine_from_artifact within 1e-5 (relative to the largest logit) of
  jitted JAX;
- K1's 5x5 pad-0 plans at the digit shapes (and ragged, strided and
  N-block ones), run through csrc/qmatmul.cu's index math in numpy
  (emulate_k1), compute the int32 conv of the plain version, which equals
  lax.conv_general_dilated's VALID conv.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet_imagenet import _jax_stages
from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from torch_port_helpers import assert_qparams_match, emulate_k1, random_like

from alignq_tpu.kernels import artifact as jart
from alignq_tpu.kernels import infer as JI
from alignq_tpu.kernels import infer_digit as JDig
from alignq_tpu.kernels import infer_resnet_imagenet as JR
from alignq_tpu_torch import interop
from alignq_tpu_torch.kernels import infer_digit as TDig
from alignq_tpu_torch.kernels import infer_resnet_imagenet as TR
from alignq_tpu_torch.kernels import qmatmul as K1
from alignq_tpu_torch.kernels.deploy_registry import DEPLOY_FAMILIES
from alignq_tpu_torch.serve import engine_from_artifact

HW = 32
pytestmark = pytest.mark.usefixtures("one_torch_thread")
TASKS = ("dann", "dsan", "mdd")


def _port(tree):
    return interop.qparams_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _rel_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(want).max())))


# ------------------------------------------------------------- converters


@functools.lru_cache(maxsize=None)
def _da_trees(task, seed=3):
    return random_like(interop.init_da_params(task, torch.Generator().manual_seed(0), "cpu", arch="resnet18"), seed)


@functools.lru_cache(maxsize=None)
def _jax_da(task):
    params, stats = _da_trees(task)
    fn = {"dann": JR.convert_dann, "dsan": JR.convert_dsan, "mdd": JR.convert_mdd}[task]
    return jax.device_get(jax.jit(fn)(params, stats))


@functools.lru_cache(maxsize=None)
def _digit_trees(seed=4):
    return random_like(interop.init_mnist_dann_params(torch.Generator().manual_seed(0), "cpu"), seed)


@functools.lru_cache(maxsize=None)
def _jax_digit():
    return jax.device_get(jax.jit(JDig.convert_mnist_dann)(*_digit_trees()))


@pytest.mark.parametrize("task", TASKS)
def test_da_converters_equal_jax(task):
    params, stats = _da_trees(task)
    fn = {"dann": TR.convert_dann, "dsan": TR.convert_dsan, "mdd": TR.convert_mdd}[task]
    got = fn(*interop.params_from_numpy(params, stats, "cpu"))
    want = _jax_da(task)
    assert_qparams_match(want, got)
    assert sorted(got[1]) == sorted(want[1]) == {"dann": ["class_classifier", "domain_classifier"],
                                                 "dsan": ["bottle", "cls_fc"],
                                                 "mdd": ["bottleneck_bn", "bottleneck_fc", "classifier"]}[task]


def test_digit_converter_equals_jax():
    got = TDig.convert_mnist_dann(*interop.params_from_numpy(*_digit_trees(), "cpu"))
    want = _jax_digit()
    assert_qparams_match(want, got)
    assert got["conv1"].kernel_int8.shape == (5, 5, 3, 32) and got["conv2"].kernel_int8.shape == (5, 5, 32, 48)
    assert sorted(got["classifier"]) == ["bn0", "bn1", "fc0", "fc1", "fc2"]
    assert sorted(got["discriminator"]) == ["bn0", "fc0", "fc1"]


# ------------------------------------------------------------ digit graph


def _jax_digit_codes(jq, x, impl):
    """The pooled relu'd codes of JAX's two conv blocks, jitted as its
    forward runs them (each conv's epilogue one FMA)."""

    def block(x8, q):
        acc = jax.lax.conv_general_dilated(x8, q.kernel_int8, (1, 1), [(0, 0)] * 2,
                                           dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                           preferred_element_type=jnp.int32)
        codes = jnp.maximum(JI._erfq_codes(acc.astype(jnp.float32) * q.scale + q.bias, 8, impl), 0)
        return jax.lax.reduce_window(codes, jnp.int8(-128), jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")

    @jax.jit
    def run(q, a):
        if a.shape[-1] == 1:
            a = jnp.tile(a, (1, 1, 1, 3))
        c1 = block(JI._linear_q(a, JDig.S_DIGIT), q["conv1"])
        return c1, block(c1, q["conv2"])

    return jax.device_get(run(jq, x))


@pytest.mark.parametrize("impl,channels", [("erf", 3), ("poly", 3), ("erf", 1)])
def test_digit_int8_codes_equal_jitted_jax(impl, channels):
    jq = _jax_digit()
    x = np.random.RandomState(5).uniform(-1, 1, (3, 28, 28, channels)).astype(np.float32)
    w1, w2 = _jax_digit_codes(jq, x, impl)
    tq = _port(jq)
    c1, c2 = TDig.mnist_dann_int8_codes(tq, torch.from_numpy(x), act_impl=impl)
    assert c1.shape == (3, 12, 12, 32) and c2.shape == (3, 4, 4, 48) and c2.dtype == torch.int8
    assert 0 < (w2 > 0).mean() < 1  # the codes are neither all zero nor all positive
    np.testing.assert_array_equal(c1.numpy(), w1)
    np.testing.assert_array_equal(c2.numpy(), w2)
    want = jax.jit(functools.partial(JDig.mnist_dann_int8_forward, act_impl=impl))(jq, x)
    got = TDig.mnist_dann_int8_forward(tq, torch.from_numpy(x), act_impl=impl)
    for g_, w_ in zip(got, want):
        _rel_close(g_.numpy(), np.asarray(w_))
    assert got[0].shape == (3, 10) and got[1].shape == (3, 2)


# ------------------------------------------------------- DA trunk forwards


@pytest.mark.parametrize("task", TASKS)
def test_da_int8_forwards_equal_jitted_jax(task):
    jq, jheads = _jax_da(task)
    x = np.random.RandomState(6).randn(2, HW, HW, 3).astype(np.float32)
    tq, theads = _port(jq), _port(jheads)
    want = _jax_stages(jq, x, 8, "erf")
    got = list(TR.resnet_imagenet_int8_streams(tq, torch.from_numpy(x)))
    assert len(got) == len(want)
    for i, (g_, w_) in enumerate(zip(got, want)):
        for k in w_:
            np.testing.assert_array_equal(g_[k].numpy(), w_[k], err_msg=f"stage {i} {k}")
    fwd = {"dann": JR.dann_int8_forward, "dsan": JR.dsan_int8_forward, "mdd": JR.mdd_int8_forward}[task]
    tfwd = {"dann": TR.dann_int8_forward, "dsan": TR.dsan_int8_forward, "mdd": TR.mdd_int8_forward}[task]
    want = jax.jit(fwd)(jq, jheads, x)
    got = tfwd(tq, theads, torch.from_numpy(x))
    want, got = (want, got) if task == "dann" else ((want,), (got,))
    for g_, w_ in zip(got, want):
        _rel_close(g_.numpy(), np.asarray(w_))
    assert got[0].shape == (2, 31)


# ---------------------------------------------------------------- serving


@pytest.mark.parametrize("family", ["dann", "dsan", "mdd", "digit_dann"])
def test_jax_saved_da_artifact_served_by_the_port(tmp_path, family):
    """An artifact as JAX's tools/export_da_int8.py --save writes it serves
    through engine_from_artifact(device='cpu'): the class logits of two
    requests within 1e-5 of jitted JAX's forward of each engine batch (the
    trunks' block-input scale is the batch's max: the trunk requests fill
    their batches; the digit net's scales are static, so its second
    request is padded)."""
    path = str(tmp_path / f"{family}.npz")
    if family == "digit_dann":
        jq = _jax_digit()
        jart.save_int8_artifact(path, jq, meta={"model": family, "weight_bits": 8, "act_bits": 8, "act_impl": "erf",
                                                "img_size": 28})
        x = np.random.RandomState(9).uniform(-1, 1, (3, 28, 28, 3)).astype(np.float32)
        reqs = [x[:2], x[2:]]
        fwd = jax.jit(lambda a: JDig.mnist_dann_int8_forward(jq, a)[0])
        want = np.asarray(fwd(x))
    else:
        jq, jheads = _jax_da(family)
        meta = {"model": family, "arch": "resnet18", "weight_bits": 8, "act_bits": 8, "act_impl": "erf",
                "image_size": HW, "num_classes": 31, **({"bottle_neck": 1} if family == "dsan" else {})}
        jart.save_int8_artifact(path, {"trunk": jq, "heads": jheads}, meta=meta)
        x = np.random.RandomState(9).randn(4, HW, HW, 3).astype(np.float32)
        reqs = [x[:2], x[2:]]
        raw = {"dann": lambda a: JR.dann_int8_forward(jq, jheads, a)[0],
               "dsan": lambda a: JR.dsan_int8_forward(jq, jheads, a),
               "mdd": lambda a: JR.mdd_int8_forward(jq, jheads, a)}[family]
        fwd = jax.jit(raw)
        want = np.concatenate([np.asarray(fwd(r)) for r in reqs])
    engine = engine_from_artifact(path, batch_size=2, device="cpu")
    try:
        assert engine.input_shape == ((28, 28, 3) if family == "digit_dann" else (HW, HW, 3))
        got = np.concatenate([engine.submit(r).result(timeout=300) for r in reqs])
    finally:
        engine.close()
    assert got.shape == want.shape == (len(x), 10 if family == "digit_dann" else 31)
    _rel_close(got, want)


def test_da_families_in_the_registry():
    """Each DA family converts the port's own tree into its template's
    structure (the trunk families {'trunk', 'heads'}), takes its request
    shape from the meta (64 and 28 by default) and lays out K1's operands
    (the digit net's two 5x5 convs, conv1 over 4 channels)."""
    for task in TASKS:
        fam = DEPLOY_FAMILIES[task]
        meta = {"model": task, "arch": "resnet18", "image_size": 48}
        assert fam.input_shape(meta) == (48, 48, 3) and fam.input_shape({"model": task}) == (64, 64, 3)
        tq = fam.template(meta, "cpu")
        assert sorted(tq) == ["heads", "trunk"] and len(tq["trunk"]["layers"]) == 8
        assert fam.operands(tq, meta)["conv1"].ksize == 7
    fam = DEPLOY_FAMILIES["digit_dann"]
    assert fam.input_shape({}) == (28, 28, 3)
    tq = fam.template({}, "cpu")
    ops = fam.operands(tq, {})
    assert (ops["conv1"].ksize, ops["conv1"].cin, ops["conv2"].ksize, ops["conv2"].cin) == (5, 4, 5, 32)


# ---------------------------------------------------------- K1's 5x5 form

# (B, H, W, Cin, ksize, stride, N): the digit convs at batches 3 and 2, a
# ragged map, a 5x5 at stride 2, and an N split into blocks
DIGIT_FORMS = [(3, 28, 28, 3, 5, 1, 32), (2, 12, 12, 32, 5, 1, 48), (1, 13, 17, 8, 5, 1, 16),
               (1, 21, 9, 4, 5, 2, 8), (1, 9, 9, 16, 5, 1, 264)]


@pytest.mark.parametrize("form", DIGIT_FORMS)
def test_k1_5x5_forms_emulated(form):
    b, h, w, cin, ksize, stride, n = form
    rng = np.random.RandomState(cin + n)
    x = torch.from_numpy(rng.randint(-127, 128, (b, h, w, cin)).astype(np.int8))
    kern = rng.randint(-127, 128, (ksize, ksize, cin, n)).astype(np.int8)
    op = K1.pack_conv_weights(torch.from_numpy(kern))
    xin = K1._conv_input(x, op)
    plan = K1.conv_plan(*xin.shape, ksize, stride, 0, *op.wt.shape)
    assert plan.pad == 0 and plan.HR == (plan.TR - 1) * stride + 5
    got = emulate_k1(xin, op, plan)
    want = K1.int8_conv_reference(x, op, stride, 0, "int32")
    np.testing.assert_array_equal(got[:, :n], want.reshape(-1, n).numpy())
    lax = jax.lax.conv_general_dilated(x.numpy(), kern, (stride, stride), [(0, 0)] * 2,
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(want.numpy(), np.asarray(lax))
    with pytest.raises(ValueError, match="5x5 pad 0"):
        K1.conv_plan(*xin.shape, ksize, stride, 2, *op.wt.shape)
