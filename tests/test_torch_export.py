"""QAT -> INT export in the port (alignq_tpu_torch/export_int8.py,
interop.deploy_tree, kernels/infer.py convert_preact_resnet).

- A deploy-exact poly QAT ResNet-20 (random init, batch 16): the port's
  fake-quant eval and its INT forward agree on >= 0.9 of the argmaxes,
  the JAX package's own bar (tests/test_poly_cdf.py).
- JAX-trained parameters carried across into the port's model and
  exported by the port give JAX's export: the same weight codes and the
  same int16 stream (pooled features bit for bit, logits within 1e-5).
- The export CLI on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alignq_tpu.kernels import infer as J
from alignq_tpu.models.resnet_cifar import PreActResNet as JNet
from alignq_tpu_torch import export_int8
from alignq_tpu_torch.interop import deploy_tree, load_flax_preact
from alignq_tpu_torch.kernels import infer as T
from alignq_tpu_torch.models.resnet_cifar import PreActResNet as TNet, resnet20_quant
from torch_port_helpers import one_torch_thread, write_tiny_cifar10  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_deploy_exact_poly_qat_agrees_with_its_int_graph():
    model = resnet20_quant(bitW=8, abitW=8, variant="int8", deploy_exact=True, cdf_impl="poly",
                           generator=torch.Generator().manual_seed(6))
    x = torch.randn((16, 32, 32, 3), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        logits_fq = model(x, train=False)
    qp = T.convert_preact_resnet(*deploy_tree(model))
    logits_i8 = T.resnet20_int8_forward(qp, x, act_impl="poly")
    agree = (logits_fq.argmax(-1) == logits_i8.argmax(-1)).float().mean()
    assert float(agree) >= 0.9
    kw = export_int8.int_forward_kwargs(8, "poly", "same", "int16", True)
    assert kw == {"act_bits": 8, "act_impl": "poly", "stream": "int16", "use_stage_kernel": True}


def _jax_trained(hw, steps=3):
    """A deploy-exact int8-variant poly (1, 1, 1) net after a few jitted
    JAX SGD steps on seeded data (f32): params and batch stats."""
    jm = JNet(num_units=(1, 1, 1), w_bit=8, a_bit=8, variant="int8", deploy_exact=True, cdf_impl="poly")
    v = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, hw, hw, 3)))
    params, stats = v["params"], v["batch_stats"]
    tx = optax.sgd(0.05, momentum=0.9)
    opt = tx.init(params)

    @jax.jit
    def step(params, stats, opt, x, y):
        def loss(p):
            logits, nv = jm.apply({"params": p, "batch_stats": stats}, x, train=True, mutable=["batch_stats"])
            return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, y)), nv["batch_stats"]

        (_, new_stats), g = jax.value_and_grad(loss, has_aux=True)(params)
        upd, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, upd), new_stats, opt

    rng = np.random.RandomState(0)
    for _ in range(steps):
        x = rng.randn(16, hw, hw, 3).astype(np.float32)
        params, stats, opt = step(params, stats, opt, x, rng.randint(0, 10, 16))
    return jax.device_get(params), jax.device_get(stats)


def test_jax_trained_params_exported_by_the_port_give_jax_stream():
    """Both sides fold the JAX-trained weights at float64: at f32 the mean
    and std of tensor_stats are summed in host-dependent orders by jitted
    XLA and move ~6e-6 of the weight codes by one (ROADMAP: known
    differences of the reference); at f64 no code is that close to a
    rounding boundary. The f32 epilogues (fold_conv_bn casts once) and the
    codes must then be JAX's exactly, and so must the int16 stream."""
    hw = 16
    params, stats = _jax_trained(hw)
    tm = TNet(num_units=(1, 1, 1), w_bit=8, a_bit=8, variant="int8", deploy_exact=True, cdf_impl="poly").double()
    load_flax_preact(tm, params, stats)
    tq = T.convert_preact_resnet(*deploy_tree(tm))
    with jax.enable_x64(True):
        as64 = functools.partial(jax.tree.map, lambda a: jnp.asarray(a, jnp.float64))
        jq = J.convert_preact_resnet(as64(params), as64(stats))  # eagerly, as the JAX export tool does
        jq = jax.tree.map(lambda a: np.asarray(a).astype(np.float32) if np.asarray(a).dtype == np.float64
                          else np.asarray(a), jq)
    pairs = [(jq["conv0"], tq["conv0"])]
    for jb, tb in zip(jq["layers"], tq["layers"]):
        pairs += [(jb[k], tb[k]) for k in ("conv0", "conv1", "skip") if k in jb]
    for jc, tc in pairs:
        np.testing.assert_array_equal(tc.kernel_int8.numpy(), jc.kernel_int8)
        np.testing.assert_array_equal(tc.scale.numpy(), jc.scale)
        np.testing.assert_array_equal(tc.bias.numpy(), jc.bias)
    x = np.random.RandomState(9).randn(8, hw, hw, 3).astype(np.float32)
    eye = jnp.eye(64, dtype=jnp.float32)
    fwd = functools.partial(J.resnet20_int8_forward, act_impl="poly")
    jq = jax.tree.map(jnp.asarray, jq)
    want_logits, want_feat = jax.jit(lambda q, a: (fwd(q, a), fwd({**q, "logit": {"kernel": eye, "bias": eye[0] * 0}},
                                                                  a)))(jq, x)
    got_c = T.resnet20_int8_stream(tq, torch.tensor(x), act_impl="poly")
    feat = T.resnet20_int8_head({**tq, "logit": {"kernel": torch.eye(64), "bias": torch.zeros(64)}}, got_c)
    np.testing.assert_array_equal(feat.numpy(), np.asarray(want_feat))
    np.testing.assert_allclose(T.resnet20_int8_head(tq, got_c).numpy(), np.asarray(want_logits), rtol=0, atol=1e-5)


def test_export_cli_on_the_cpu(tmp_path):
    """Export a run the training CLI made (two steps of batch 8: the
    export's own training is what fit runs, tests/test_torch_train.py),
    save the artifact and load it back."""
    from alignq_tpu_torch.train import cli

    job, art = tmp_path / "job", tmp_path / "net.npz"
    qat = ["--cdf_impl", "poly", "--deploy_exact", "--admm", "--job_dir", str(job), "--dataset", "cifar10",
           "--data_dir", write_tiny_cifar10(tmp_path / "data", n_test=16)]
    cli.main(["--device", "cpu", "--max_steps", "2", "--num_epochs", "1", "--train_batch_size", "8",
              "--eval_batch_size", "8", "--variant", "int8"] + qat)
    out = export_int8.main(["--device", "cpu", "--epochs", "1", "--batch", "8", "--stage_kernel", "--resume",
                            "--save", str(art)] + qat)
    assert out["state"].step == 2 and out["agreement"] >= 90.0 and art.is_file()
    from alignq_tpu_torch.kernels.artifact import forward_kwargs_from_meta, load_int8_artifact

    qp, meta = load_int8_artifact(str(art), out["qparams"])
    assert forward_kwargs_from_meta(meta) == {"act_bits": 8, "act_impl": "poly", "stream": "int16"}
    assert torch.equal(qp["layers"][0]["conv0"].kernel_int8, out["qparams"]["layers"][0]["conv0"].kernel_int8)
