"""alignq_tpu_torch serving and artifacts, on the CPU: engine batching and
padding, artifacts shared with the JAX package both ways, the default
device, and the package boundary (the port never imports JAX)."""

import functools
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from alignq_tpu.kernels import artifact as jart
from alignq_tpu.kernels import infer as J
from alignq_tpu_torch import interop
from alignq_tpu_torch.kernels import artifact as tart
from alignq_tpu_torch.kernels import infer as T
from alignq_tpu_torch.serve import BatchedInferenceEngine, build_int8_resnet20_engine
from torch_port_helpers import random_preact_tree

REPO = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _tree():
    return random_preact_tree(20, seed=3)


def _images(n, seed):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


@pytest.mark.parametrize(
    "knobs", [{}, {"act_impl": "poly", "use_stage_kernel": True, "use_pallas_1x1": True}]
)
def test_engine_batches_and_pads(knobs):
    params, stats = _tree()
    engine = build_int8_resnet20_engine(params, stats, batch_size=8, device="cpu", **knobs)
    try:
        reqs = [_images(n, seed) for seed, n in enumerate((3, 1, 4, 8))]
        outs = [f.result(timeout=120) for f in [engine.submit(r) for r in reqs]]
        qp = T.convert_resnet20(*interop.params_from_numpy(params, stats, "cpu"))
        for r, o in zip(reqs, outs):
            assert o.shape == (r.shape[0], 10) and np.isfinite(o).all()
            # padding and co-batched requests do not leak into a result
            direct = T.resnet20_int8_forward(qp, torch.from_numpy(r), **{
                k: v for k, v in knobs.items()
            }).numpy()
            np.testing.assert_array_equal(o, direct)
        again = engine.submit(reqs[0]).result(timeout=120)
        np.testing.assert_array_equal(again, outs[0])
    finally:
        engine.close()


def test_engine_propagates_exceptions():
    calls = []

    def forward(params, x):
        calls.append(x.shape)
        if len(calls) > 1:
            raise RuntimeError("boom")
        return x.reshape(x.shape[0], -1)[:, :2]

    engine = BatchedInferenceEngine(forward, None, 4, (2, 2), device="cpu")
    try:
        fut = engine.submit(np.ones((2, 2, 2), np.float32))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=30)
    finally:
        engine.close()
    assert calls[0] == (4, 2, 2)  # the warm-up forward runs at the full batch


def test_engine_runs_under_inference_mode():
    seen = {}

    def forward(params, x):
        seen[threading.current_thread().name] = torch.is_inference_mode_enabled()
        return x[:, :1]

    engine = BatchedInferenceEngine(forward, None, 2, (3,), device="cpu")
    try:
        engine.submit(np.zeros((1, 3), np.float32)).result(timeout=30)
    finally:
        engine.close()
    assert all(seen.values()) and len(seen) == 2


def test_submit_validates():
    engine = BatchedInferenceEngine(lambda p, x: x, None, 2, (3,), device="cpu")
    try:
        with pytest.raises(ValueError):
            engine.submit(np.zeros((3, 3), np.float32))
        with pytest.raises(ValueError):
            engine.submit(np.zeros((1, 4), np.float32))
    finally:
        engine.close()


def test_mesh_not_ported():
    """Mesh serving is ported (tests/test_torch_tp_serve.py); JAX's refusal
    stays: an engine batch the mesh's data axis does not divide."""
    from alignq_tpu_torch.dist.mesh import Mesh

    params, stats = _tree()
    with pytest.raises(ValueError, match="divisible"):
        build_int8_resnet20_engine(params, stats, batch_size=12, mesh=Mesh(("data",), (8,), None, 0), device="cpu")


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    params, stats = _tree()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_int8_resnet20_engine(params, stats)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.build_resnet20_int8(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedInferenceEngine(lambda p, x: x, None, 2, (3,))


META = {"model": "resnet20", "act_bits": 8, "act_impl": "poly", "stream": "int16"}


def _jax_qparams():
    params, stats = _tree()
    return J.convert_resnet20(params, stats)


def test_jax_artifact_serves_in_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    jq = _jax_qparams()
    jart.save_int8_artifact(path, jq, meta=META)
    template = T.convert_resnet20(*interop.params_from_numpy(*random_preact_tree(20, seed=4), "cpu"))
    tq, meta = tart.load_int8_artifact(path, template)
    kw = tart.forward_kwargs_from_meta(meta)
    assert kw == {"act_bits": 8, "act_impl": "poly", "stream": "int16"}
    x = _images(4, 9)
    got = T.resnet20_int8_forward(tq, torch.from_numpy(x), use_stage_kernel=True, **kw)
    want = jax.jit(functools.partial(J.resnet20_int8_forward, **kw))(jq, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_port_artifact_serves_in_jax(tmp_path):
    path = str(tmp_path / "port.npz")
    tq = interop.qparams_from_numpy(jax.tree.map(np.asarray, _jax_qparams()), "cpu")
    tart.save_int8_artifact(path, tq, meta=META)
    jq, meta = jart.load_int8_artifact(path, J.convert_resnet20(*random_preact_tree(20, seed=4)))
    kw = jart.forward_kwargs_from_meta(meta)
    x = _images(4, 10)
    want = jax.jit(functools.partial(J.resnet20_int8_forward, **kw))(jq, x)
    got = T.resnet20_int8_forward(tq, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # the same keys as the JAX package writes
    jpath = str(tmp_path / "jax.npz")
    jart.save_int8_artifact(jpath, _jax_qparams(), meta=META)
    assert sorted(np.load(path).files) == sorted(np.load(jpath).files)


def test_forward_kwargs_from_meta_rejects_unknown():
    with pytest.raises(ValueError):
        tart.forward_kwargs_from_meta({"act_impl": np.asarray("spline")})
    with pytest.raises(ValueError):
        tart.forward_kwargs_from_meta({"stream": np.asarray("int4")})


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, alignq_tpu_torch\n"
        "for m in pkgutil.walk_packages(alignq_tpu_torch.__path__, 'alignq_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'alignq_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('alignq_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 10
