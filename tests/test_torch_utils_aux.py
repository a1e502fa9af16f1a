"""The port's last utilities against the JAX package's, on the same numpy
inputs from a seed:

- utils/meters.py accuracy_topk: JAX's percentages exactly, on rows whose
  quantized logits tie too (both rank by numpy's argsort; torch.topk
  breaks the ties its own way);
- data/augment.py random_crop_flip: bit for bit, uint8 and f32 NHWC at
  pad 4 and 2, and the generator's state after it the same; the port's
  augment_normalize is normalize(random_crop_flip(...)), bit for bit
  JAX's pair;
- quant/ste.py dequant_division: uniform_quantize inside it bit for bit
  JAX's at f64 on tests/test_quant_core.py's grid (k = 4 and the n = 127
  grid); the baselines' grids likewise; APoT's own grid untouched; the
  mode restored after an exception;
- utils/compression.py compression_info: JAX's dicts exactly, over
  ResNet-20 (JAX's own init), DenseNet-40 and MobileNet-V2 (the port's
  models against the same trees by interop.init_*_params, JAX's key
  names and shapes: flax's init of those two takes 26-76 s), with
  include_first and with a bits_fn on JAX's paths, which sees the same
  paths in the same order;
- utils/profiling.py: cost_analysis of a 128x128 f32 matmul gives JAX's
  flops and bytes_accessed exactly, and of the bench graph at batch 2
  bench.resnet20_analytic_ops(2) flops (its convs counted once, by their
  kernels' formula, on the CPU as on a card); a product it cannot count
  raises; measure_steady_state and trace run.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignq_tpu.data import augment as jaugment
from alignq_tpu.quant import baselines as jbase
from alignq_tpu.quant import ste as jste
from alignq_tpu.utils import compression as jcomp
from alignq_tpu.utils import meters as jmeters
from alignq_tpu.utils import profiling as jprof
from alignq_tpu_torch.data import augment as taugment
from alignq_tpu_torch.quant import baselines as tbase
from alignq_tpu_torch.quant import ste as tste
from alignq_tpu_torch.utils import accuracy_topk, profiling
from alignq_tpu_torch.utils.compression import compression_info
from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.numpy()


# --------------------------------------------------------------- accuracy_topk


def test_accuracy_topk_matches_jax_on_tied_logits():
    rng = np.random.RandomState(0)
    logits = np.round(rng.randn(512, 10) * 2).astype(np.float32) / 2  # quantized: rows with ties
    labels = rng.randint(0, 10, 512)
    tied = [len(np.unique(r)) < 10 for r in logits]
    assert sum(tied) > 400
    want = jmeters.accuracy_topk(logits, labels, topk=(1, 2, 5))
    assert accuracy_topk(logits, labels, topk=(1, 2, 5)) == want
    assert accuracy_topk(torch.from_numpy(logits), torch.from_numpy(labels), topk=(1, 2, 5)) == want


# ------------------------------------------------------------ random_crop_flip


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("pad", [4, 2])
def test_random_crop_flip_bit_for_bit(dtype, pad):
    rng = np.random.RandomState(3)
    x = rng.randint(0, 256, (16, 32, 32, 3)).astype(dtype) if dtype == np.uint8 else \
        rng.randn(16, 32, 32, 3).astype(dtype)
    r_j, r_t = np.random.RandomState(7), np.random.RandomState(7)
    want = jaugment.random_crop_flip(x, r_j, pad=pad)
    got = taugment.random_crop_flip(x, r_t, pad=pad)
    assert got.dtype == want.dtype and np.array_equal(got.view(np.uint8), want.view(np.uint8))
    assert r_j.randint(1 << 30) == r_t.randint(1 << 30)  # the same draws


def test_augment_normalize_is_normalize_of_the_crop():
    x = np.random.RandomState(4).randint(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    mean, std = np.float32([0.49, 0.48, 0.45]), np.float32([0.25, 0.24, 0.26])
    want = jaugment.normalize(jaugment.random_crop_flip(x, np.random.RandomState(5)), mean, std)
    got = taugment.augment_normalize(x, np.random.RandomState(5), mean, std)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# ------------------------------------------------------------ dequant_division


GRID = np.linspace(-0.999, 0.999, 4097)  # tests/test_quant_core.py's


@pytest.mark.parametrize("k,n", [(4, None), (3, None), (5, None), (8, 127)])
def test_dequant_division_bit_for_bit_with_jax(k, n):
    x = torch.from_numpy(GRID)
    with jax.enable_x64(True):
        xj = jnp.asarray(GRID, jnp.float64)
        want_recip = np.asarray(jste.uniform_quantize(xj, k, n))
        with jste.dequant_division():
            want_div = np.asarray(jste.uniform_quantize(xj, k, n))
    with tste.dequant_division():
        got_div = tste.uniform_quantize(x, k, n).numpy()
    got_recip = tste.uniform_quantize(x, k, n).numpy()
    assert np.array_equal(got_div.view(np.uint64), want_div.view(np.uint64))
    assert np.array_equal(got_recip.view(np.uint64), want_recip.view(np.uint64))
    if k != 4:  # j / n and j * (1 / n) part at f64 for n = 7, 31 and 127 (not 15)
        assert not np.array_equal(got_div, got_recip)


def test_dequant_division_reaches_the_baselines_not_apot():
    """The baselines' grids in the mode: uniform's bit for bit JAX's; the
    elements that the mode moves the same in both packages for DoReFa and
    BWN too (their tanh and mean part by an ulp between the libraries, as
    tests/test_torch_baselines.py allows); APoT's uniform grid not moved."""
    w = np.random.RandomState(8).randn(3, 3, 8, 16) * 0.3
    fns = {"uniform": (jbase.uniform_weight, tbase.uniform_weight), "dorefa": (jbase.dorefa_weight, tbase.dorefa_weight),
           "bwn": (jbase.bwn_weight, tbase.bwn_weight), "act": (jbase.uniform_act, tbase.uniform_act)}
    out = {}
    with jax.enable_x64(True):
        for div in (False, True):
            with jste.dequant_division() if div else contextlib.nullcontext():
                for name, (jf, _) in fns.items():
                    out["jax", div, name] = np.asarray(jf(jnp.asarray(np.abs(w) if name == "act" else w), 5))
    for div in (False, True):
        with tste.dequant_division() if div else contextlib.nullcontext():
            for name, (_, tf) in fns.items():
                out["port", div, name] = tf(torch.from_numpy(np.abs(w) if name == "act" else w), 5).numpy()
            out["port", div, "apot"] = tbase._apot_project(torch.from_numpy(np.abs(w)), 5, False).numpy()
    for name in ("uniform", "act"):
        for div in (False, True):
            assert np.array_equal(out["port", div, name], out["jax", div, name]), (name, div)
    moved = 0
    for name in fns:
        moved_t = out["port", True, name] != out["port", False, name]
        assert np.array_equal(moved_t, out["jax", True, name] != out["jax", False, name]), name
        moved += int(moved_t.sum())
    assert moved > 0
    assert np.array_equal(out["port", True, "apot"], out["port", False, "apot"])


def test_dequant_division_restored_after_an_exception():
    x = torch.from_numpy(GRID)
    before = tste.uniform_quantize(x, 4)
    with pytest.raises(ZeroDivisionError):
        with tste.dequant_division():
            with tste.dequant_division():
                pass
            assert tste._DEQUANT_MODE == "div"
            1 / 0
    assert tste._DEQUANT_MODE == "recip"
    assert torch.equal(tste.uniform_quantize(x, 4), before)


# ----------------------------------------------------------- compression_info


def _bits(path):
    return 4 if "layers_1" in path or path.startswith("dense2") or "conv2" in path else 8


def _compare(port_obj, jax_tree):
    for kw in ({}, {"w_bit": 4}, {"include_first": True}, {"bits_fn": _bits}, {"bits_fn": _bits, "include_first": True}):
        assert compression_info(port_obj, **kw) == jcomp.compression_info(jax_tree, **kw), kw
    seen_t, seen_j = [], []
    compression_info(port_obj, bits_fn=lambda p: seen_t.append(p) or 8)
    jcomp.compression_info(jax_tree, bits_fn=lambda p: seen_j.append(p) or 8)
    assert seen_t == seen_j and seen_t


def test_compression_info_resnet20_against_jax_init():
    from alignq_tpu.models import resnet20_quant as jresnet20
    from alignq_tpu_torch.models import resnet20_quant

    variables = jax.jit(lambda k: jresnet20(8, 8, "ours").init(k, jnp.zeros((1, 32, 32, 3)), train=False))(
        jax.random.PRNGKey(0))
    model = resnet20_quant(8, 8, "ours", generator=torch.Generator().manual_seed(0))
    _compare(model, jax.tree.map(np.asarray, variables["params"]))
    assert compression_info(model)["num_conv_layers"] == 21


@pytest.mark.parametrize("family", ["densenet40", "mobilenetv2"])
def test_compression_info_families(family):
    from alignq_tpu_torch import interop
    from alignq_tpu_torch.models import densenet_40_quant, mobile_v2

    gen = torch.Generator().manual_seed(0)
    if family == "densenet40":
        params, _ = interop.init_densenet_params(40, gen, "cpu")
        model = densenet_40_quant(8, 8, "ours", generator=torch.Generator().manual_seed(1))
    else:
        params, _ = interop.init_mobilenetv2_params(gen, "cpu")
        model = mobile_v2(8, 8, "ours", generator=torch.Generator().manual_seed(1))
    tree = _numpy_tree(params)
    _compare(tree, tree)  # the port over JAX's tree layout
    _compare(model, tree)  # a model: its deploy tree's paths and shapes are JAX's
    if family == "mobilenetv2":  # its depthwise kernels counted as JAX's (3, 3, 1, C)
        assert tree["layers_0"]["conv2"]["kernel"].shape == (3, 3, 1, 32)
        assert dict(model.named_parameters())["layers_0.conv2.kernel"].shape == (32, 1, 3, 3)


# ------------------------------------------------------------------ profiling


def test_cost_analysis_matmul_matches_jax():
    want = jprof.cost_analysis(lambda x: jnp.dot(x, x, precision=jax.lax.Precision.HIGHEST), jnp.ones((128, 128)))
    got = profiling.cost_analysis(lambda x: x @ x, torch.ones(128, 128))
    assert got == want


def test_cost_analysis_bench_graph_counts_each_conv_once(one_torch_thread):
    from alignq_tpu_torch.bench import resnet20_analytic_ops
    from alignq_tpu_torch.kernels.infer import build_resnet20_int8, pack_int8_operands, resnet20_int8_forward

    _, (qp, x) = build_resnet20_int8(2, device="cpu")
    ops = pack_int8_operands(qp)
    info = profiling.cost_analysis(
        lambda q, x: resnet20_int8_forward(q, x, act_impl="poly", stream="int8", operands=ops), qp, x)
    assert info["flops"] == resnet20_analytic_ops(2)
    assert info["bytes_accessed"] > x.numel() * 4 and info["arithmetic_intensity"] > 0


def test_cost_analysis_raises_where_it_cannot_count():
    with pytest.raises(NotImplementedError, match="aten.mv"):
        profiling.cost_analysis(lambda a, v: torch.mv(a, v), torch.ones(8, 8), torch.ones(8))


def test_measure_steady_state_and_trace(tmp_path):
    x = torch.ones(128, 128)
    t = profiling.measure_steady_state(lambda x: x @ x, x, iters=3, warmup=1)
    assert t["seconds_per_iter"] > 0 and t["achieved_flops_per_sec"] == 2 * 128**3 / t["seconds_per_iter"]
    with profiling.trace(str(tmp_path / "trace")):
        x @ x
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1 and "traceEvents" in json.loads(traces[0].read_text())
