"""Artifacts of every CIFAR deploy family served by alignq_tpu_torch on the
CPU: int4 packing byte for byte as the JAX package's, artifacts saved by
the JAX package served through the port's engine_from_artifact with JAX's
jitted logits, a port-saved artifact served by the JAX package's engine,
the registry's refusals, and export_int8 --pack_int4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignq_tpu.kernels import artifact as jart
from alignq_tpu.kernels import convert as jconv
from alignq_tpu.kernels import infer as JI
from alignq_tpu.kernels import infer_densenet as JD
from alignq_tpu.kernels import infer_mobilenet as JM
from alignq_tpu_torch.kernels import artifact as tart
from alignq_tpu_torch.kernels import convert as tconv
from alignq_tpu_torch.kernels.deploy_registry import DEPLOY_FAMILIES
from alignq_tpu_torch.serve import engine_from_artifact
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: fixture)
    one_torch_thread,
    random_densenet_tree,
    random_mobilenet_tree,
    random_preact_tree,
    write_tiny_cifar10,
)


def _images(n, seed):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


# ------------------------------------------------------------- int4 packing


@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (1, 1, 8, 6), (2, 4)])
def test_int4_pack_is_jax_bytes(shape):
    codes = np.random.RandomState(len(shape)).randint(-7, 8, shape).astype(np.int8)
    want = np.asarray(jconv.pack_int4(jnp.asarray(codes)))
    got = tconv.pack_int4(torch.from_numpy(codes))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tconv.unpack_int4(got).numpy(), codes)
    # every byte value unpacks as JAX unpacks it
    every = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(tconv.unpack_int4(torch.from_numpy(every)).numpy(),
                                  np.asarray(jconv.unpack_int4(jnp.asarray(every))))
    with pytest.raises(ValueError):
        tconv.pack_int4(torch.zeros((3, 3), dtype=torch.int8))


def test_pack_qparams_int4_matches_jax():
    """A W4 PreAct tree packed by both packages: the same leaves, byte for
    byte; unpacking gives the codes back."""
    params, stats = random_preact_tree(20, seed=8)
    jq = jax.jit(functools.partial(JI.convert_preact_resnet, weight_bits=4, act_bits=4))(params, stats)
    from alignq_tpu_torch import interop

    tq = interop.qparams_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    jp = jax.tree.map(np.asarray, jconv.pack_qparams_int4(jq))
    tp = tconv.pack_qparams_int4(tq)
    from alignq_tpu_torch.kernels.artifact import _leaves

    tleaves = [leaf for _, leaf in _leaves(tp)]
    jleaves = jax.tree.leaves(jp)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_array_equal(t.numpy() if torch.is_tensor(t) else np.asarray(t), j)
    back = tconv.unpack_qparams_int4(tp)
    assert torch.equal(back["layers"][3]["conv1"].kernel_int8, tq["layers"][3]["conv1"].kernel_int8)
    from alignq_tpu_torch.kernels.infer import resnet20_int8_forward

    x = torch.from_numpy(_images(1, 70))
    got = tconv.packed_int4_forward(resnet20_int8_forward, tp, x, act_bits=4, act_impl="bins")
    assert torch.equal(got, resnet20_int8_forward(tq, x, act_bits=4, act_impl="bins"))


# ---------------------------------------------- JAX artifacts, port engine


def _jit_convert(fn, *args, **kw):
    """JAX's converter, jitted (eagerly it dispatches op by op, ~40 s for
    DenseNet-40)."""
    return jax.jit(functools.partial(fn, **kw))(*args)


def _serve(path, x, batch=None):
    engine = engine_from_artifact(path, batch_size=batch or len(x), device="cpu")
    try:
        return engine.submit(x).result(timeout=300)
    finally:
        engine.close()


def _jax_case(name):
    """(qparams saved by JAX, meta, JAX's direct forward on them)."""
    if name == "resnet56":
        qp = _jit_convert(JI.convert_preact_resnet, *random_preact_tree(56, seed=1))
        meta = {"model": "resnet56", "act_bits": 8, "weight_bits": 8, "act_impl": "erf", "stream": "int16"}
        return qp, qp, meta, functools.partial(JI.resnet20_int8_forward, act_impl="erf")
    if name == "densenet40":
        qp = _jit_convert(JD.convert_densenet40, *random_densenet_tree(40, seed=2, stage_int8=True), stage_int8=True)
        meta = {"model": "densenet40", "act_bits": 8, "weight_bits": 8, "act_impl": "erf", "stage_int8": 1}
        return qp, qp, meta, functools.partial(JD.densenet40_int8_forward, stage_int8=True)
    if name == "mobilenetv2":
        qp = _jit_convert(JM.convert_mobilenetv2, *random_mobilenet_tree(seed=3))
        meta = {"model": "mobilenetv2", "act_bits": 8, "weight_bits": 8, "act_impl": "erf"}
        return qp, qp, meta, JM.mobilenetv2_int8_forward
    if name == "resnet20_w4a4_packed":
        qp = _jit_convert(JI.convert_preact_resnet, *random_preact_tree(20, seed=4), weight_bits=4, act_bits=4)
        meta = {"model": "resnet20", "act_bits": 4, "weight_bits": 4, "act_impl": "bins", "stream": "int16",
                "packed_int4": 1}
        return jconv.pack_qparams_int4(qp), qp, meta, functools.partial(JI.resnet20_int8_forward, act_bits=4,
                                                                          act_impl="bins")
    assert name == "resnet20_w4a4_bins_int"
    qp = _jit_convert(JI.convert_preact_resnet, *random_preact_tree(20, seed=5), weight_bits=4, act_bits=4)
    meta = {"model": "resnet20", "act_bits": 4, "weight_bits": 4, "act_impl": "bins_int", "stream": "int16"}
    return qp, JI.augment_int_cutpoints(qp, 4), meta, functools.partial(JI.resnet20_int8_forward, act_bits=4,
                                                                         act_impl="bins_int")


@pytest.mark.parametrize("name", ["resnet56", "densenet40", "mobilenetv2", "resnet20_w4a4_packed",
                                  "resnet20_w4a4_bins_int"])
def test_jax_artifact_serves_in_port(one_torch_thread, tmp_path, name):
    """An artifact saved by alignq_tpu.kernels.artifact serves through the
    port's engine_from_artifact on the CPU: the logits of JAX's jitted
    forward on the same qparams, to within 1e-5 (the port's heads are
    float64, rounded once)."""
    saved, direct, meta, fwd = _jax_case(name)
    path = str(tmp_path / f"{name}.npz")
    jart.save_int8_artifact(path, saved, meta=meta)
    x = _images(2, 40 + len(name))
    got = _serve(path, x)
    want = np.asarray(jax.jit(fwd)(direct, x))
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_port_artifact_serves_in_jax(one_torch_thread, tmp_path):
    """A W4A4 ResNet-20 frozen and int4-packed by the port, saved by the
    port, serves through the JAX package's engine_from_artifact with the
    port engine's logits."""
    from alignq_tpu.serve import engine_from_artifact as jax_engine_from_artifact
    from alignq_tpu_torch import interop
    from alignq_tpu_torch.kernels.infer import convert_preact_resnet

    params, stats = random_preact_tree(20, seed=6)
    tq = convert_preact_resnet(*interop.params_from_numpy(params, stats, "cpu"), weight_bits=4, act_bits=4)
    path = str(tmp_path / "port_w4.npz")
    tart.save_int8_artifact(path, tconv.pack_qparams_int4(tq), meta={
        "model": "resnet20", "act_bits": 4, "weight_bits": 4, "act_impl": "bins", "stream": "int16",
        "packed_int4": 1})
    x = _images(2, 50)
    engine = jax_engine_from_artifact(path, batch_size=2)
    try:
        want = engine.submit(x).result(timeout=300)
    finally:
        engine.close()
    np.testing.assert_allclose(_serve(path, x), want, rtol=0, atol=1e-5)


def test_registry_refusals(tmp_path):
    bogus = str(tmp_path / "bogus.npz")
    jart.save_int8_artifact(bogus, {"w": np.zeros(1)}, meta={"model": "vgg"})
    with pytest.raises(ValueError, match="deploy registry"):
        engine_from_artifact(bogus, device="cpu")
    # the domain-adaptation families serve (tests/test_torch_da_deploy.py): an
    # artifact of theirs without their trees is refused at load, by the key missing
    da = str(tmp_path / "dann.npz")
    jart.save_int8_artifact(da, {"w": np.zeros(1)}, meta={"model": "dann", "arch": "resnet18"})
    with pytest.raises(KeyError, match="trunk"):
        engine_from_artifact(da, device="cpu")
    packed_dn = str(tmp_path / "dn.npz")
    jart.save_int8_artifact(packed_dn, {"w": np.zeros(1)}, meta={"model": "densenet40", "packed_int4": 1})
    with pytest.raises(ValueError, match="int4"):
        engine_from_artifact(packed_dn, device="cpu")
    # a mesh: a one-device mesh serves as the plain engine (meshes of ranks:
    # tests/test_torch_tp_serve.py)
    from alignq_tpu_torch import interop
    from alignq_tpu_torch.dist import make_mesh
    from alignq_tpu_torch.kernels.infer import convert_preact_resnet

    params, stats = random_preact_tree(20, seed=8)
    tq = convert_preact_resnet(*interop.params_from_numpy(params, stats, "cpu"))
    path = str(tmp_path / "r20.npz")
    tart.save_int8_artifact(path, tq, meta={"model": "resnet20", "act_impl": "poly", "stream": "int16"})
    x = np.random.RandomState(9).randn(2, 32, 32, 3).astype(np.float32)
    outs = []
    for mesh in (None, make_mesh((1, 1))):
        engine = engine_from_artifact(path, batch_size=2, mesh=mesh, device="cpu")
        try:
            outs.append(engine.submit(x).result(timeout=120))
        finally:
            engine.close()
    np.testing.assert_array_equal(outs[1], outs[0])
    assert {"resnet20", "resnet56", "densenet40", "mobilenetv2", "resnet18", "resnet34", "resnet50", "dann",
            "dsan", "mdd", "digit_dann"} == set(DEPLOY_FAMILIES)


def test_bins_int_artifact_without_act_bits_refused_at_load(tmp_path):
    """A bins_int artifact whose meta drops act_bits is refused by
    engine_from_artifact at load: its cutpoints' grid would not be the
    forward's."""
    from alignq_tpu_torch import interop
    from alignq_tpu_torch.kernels.infer import convert_preact_resnet

    params, stats = random_preact_tree(20, seed=7)
    tq = convert_preact_resnet(*interop.params_from_numpy(params, stats, "cpu"), weight_bits=4, act_bits=4)
    path = str(tmp_path / "bins_int_no_bits.npz")
    tart.save_int8_artifact(path, tq, meta={"model": "resnet20", "weight_bits": 4, "act_impl": "bins_int",
                                            "stream": "int16"})
    with pytest.raises(ValueError, match="act_bits"):
        engine_from_artifact(path, batch_size=2, device="cpu")


@pytest.mark.parametrize("name", ["resnet20", "resnet56", "densenet40", "mobilenetv2"])
def test_port_templates_have_jax_keys(name):
    """The port's template of each family and a tree JAX's converter makes
    hold the same artifact keys, so that artifacts load both ways."""
    from alignq_tpu_torch.kernels.artifact import _leaves

    meta = {"model": np.asarray(name), "stage_int8": np.asarray(1)}
    ours = sorted(k for k, _ in _leaves(DEPLOY_FAMILIES[name].template(meta, torch.device("cpu"))))
    if name.startswith("resnet"):
        jq = _jit_convert(JI.convert_preact_resnet, *random_preact_tree(int(name[6:]), seed=0))
    elif name == "densenet40":
        jq = _jit_convert(JD.convert_densenet40, *random_densenet_tree(40, seed=0, stage_int8=True), stage_int8=True)
    else:
        jq = _jit_convert(JM.convert_mobilenetv2, *random_mobilenet_tree(seed=0))
    theirs = sorted(
        "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p)))) for p in kp)
        for kp, _ in jax.tree_util.tree_flatten_with_path(jq)[0]
    )
    assert ours == theirs


# --------------------------------------------------------- export --pack_int4


def test_export_pack_int4_serves_as_unpacked(one_torch_thread, tmp_path):
    """export_int8 --bits 4 --pack_int4 writes packed kernels and
    packed_int4: 1; the packed artifact serves the unpacked one's logits.
    --pack_int4 is refused without --bits 4 and with bins_int."""
    from alignq_tpu_torch import export_int8
    from alignq_tpu_torch.train import cli

    job = tmp_path / "job"
    qat = ["--job_dir", str(job), "--dataset", "cifar10", "--data_dir", write_tiny_cifar10(tmp_path / "data", n_test=8)]
    cli.main(["--device", "cpu", "--max_steps", "1", "--num_epochs", "1", "--train_batch_size", "8",
              "--eval_batch_size", "8", "--variant", "int8", "--bitW", "4", "--abitW", "4"] + qat)
    paths = {}
    for packed in (False, True):
        paths[packed] = str(tmp_path / f"w4_{int(packed)}.npz")
        export_int8.main(["--device", "cpu", "--epochs", "1", "--batch", "8", "--bits", "4", "--resume",
                          "--save", paths[packed]] + (["--pack_int4"] if packed else []) + qat)
    with np.load(paths[True]) as f:
        assert int(f["__meta__/packed_int4"]) == 1 and f["conv0/kernel_int8"].dtype == np.uint8
        assert f["conv0/kernel_int8"].shape == (3, 3, 3, 8)
    x = _images(3, 60)
    np.testing.assert_array_equal(_serve(paths[True], x), _serve(paths[False], x))
    for bad in (["--bits", "8", "--pack_int4"], ["--bits", "4", "--deploy_act_impl", "bins_int", "--pack_int4"]):
        with pytest.raises(SystemExit):
            export_int8.main(["--device", "cpu", "--resume", "--save", str(tmp_path / "x.npz")] + bad + qat)
