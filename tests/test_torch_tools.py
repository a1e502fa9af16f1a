"""The port's measurement tools (alignq_tpu_torch/tools/) against the JAX
package's (tools/), on the CPU:

- shape_ceilings.conv_inventory of the bench's graph at batch 2 (poly act
  sites, int8 stream), recorded at the kernels' entry points, equals the
  JAX tool's conv_inventory of the jitted JAX graph on the same weights,
  both mapped to (count, cin, cout, hw, ksize, stride), and bench.py's
  RESNET20_CONVS: exact;
- preact_epilogue_inventory's act, add and requant counts equal the JAX
  tool's at depths 20 and 56: exact;
- epilogue_ops, the ops that epilogue_isolated_ms prices, are the ops the
  bench's graph dispatches outside its kernels at depths 20 and 56, each
  counted by (op, result shape, dtype) under a dispatch mode: exact;
- artifact_bench.tree_bytes of the same ResNet-20 trees (f32 params, W8A8
  and W4A4 codes, W4A4 nibble-packed) equals the JAX tool's: exact;
- each tool's --smoke --device cpu runs its cheapest row in this process
  and prints the card line first; without --device each raises where
  there is no card.
"""

import collections
import json
import tempfile

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)

TOOLS = ("shape_ceilings", "model_zoo_bench", "serve_bench", "artifact_bench", "qat_throughput", "qat_breakdown",
         "corr_mode_ab", "stage_calib_ab")


def _numpy_tree(tree):
    return {k: _numpy_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.numpy()


def _resnet20(bits=8):
    from alignq_tpu_torch.interop import init_preact_resnet_params

    return init_preact_resnet_params(20, torch.Generator().manual_seed(1), "cpu")


def test_conv_inventory_matches_jax_and_bench(one_torch_thread):
    from alignq_tpu.kernels import infer as jinfer
    from alignq_tpu_torch.bench import RESNET20_CONVS
    from alignq_tpu_torch.kernels import infer as tinfer
    from alignq_tpu_torch.tools import shape_ceilings as tsc
    from tools import shape_ceilings as jsc

    params, stats = _resnet20()
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    qp = tinfer.convert_resnet20(params, stats)
    ops = tinfer.pack_int8_operands(qp)
    inv = tsc.conv_inventory(lambda: tinfer.resnet20_int8_forward(qp, x, act_impl="poly", stream="int8",
                                                                   operands=ops))
    got = tsc.conv_rows(inv)

    jqp = jax.jit(jinfer.convert_resnet20)(_numpy_tree(params), _numpy_tree(stats))
    jinv = jsc.conv_inventory(jax.jit(lambda q, xx: jinfer.resnet20_int8_forward(q, xx, act_impl="poly",
                                                                                 stream="int8")), jqp, x.numpy())
    want = sorted((n, key[0][-1], key[1][-1], key[0][1], key[1][0], key[3][0]) for key, n in jinv.items())
    assert got == want == sorted(RESNET20_CONVS)
    assert sum(count for count, _ in inv.values()) == 21


@pytest.mark.parametrize("depth", [20, 56])
def test_epilogue_inventory_matches_jax(depth):
    from alignq_tpu_torch.tools import shape_ceilings as tsc
    from tools import shape_ceilings as jsc

    assert tsc.preact_epilogue_inventory(depth, 2) == jsc.preact_epilogue_inventory(depth, 2)


class _Ops(TorchDispatchMode):
    """Counts each dispatched op by (op, result shape, result dtype)."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops[(str(func), tuple(out.shape), out.dtype)] += 1
        return out


@pytest.mark.parametrize("depth", [20, 56])
def test_epilogue_ops_are_what_the_graph_runs_outside_its_kernels(depth, one_torch_thread):
    from alignq_tpu_torch.interop import init_preact_resnet_params
    from alignq_tpu_torch.kernels import infer as tinfer
    from alignq_tpu_torch.tools import shape_ceilings as tsc
    from alignq_tpu_torch.utils.launches import at_entry_points

    params, stats = init_preact_resnet_params(depth, torch.Generator().manual_seed(1), "cpu")
    qp = tinfer.convert_preact_resnet(params, stats)
    ops = tinfer.pack_int8_operands(qp)
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))

    def kernel(call):  # a kernel's call, uncounted
        with _disable_current_modes():
            return call.fn(**call.args)

    graph = _Ops()
    with torch.inference_mode(), at_entry_points(kernel), graph:
        tinfer.resnet20_int8_forward(qp, x, act_impl="poly", stream="int8", operands=ops)
    priced = _Ops()
    with torch.inference_mode():
        for (op, shape, m), count in tsc.epilogue_ops(depth, 2).items():
            call = tsc.epilogue_call(op, shape, m, torch.device("cpu"))
            with priced:
                for _ in range(count):
                    call()
    assert priced.ops == graph.ops


def test_artifact_bytes_match_jax(one_torch_thread):
    """The port's tree_bytes equals the JAX tool's over each format's tree,
    and the port's trees hold the leaves JAX's converter and packer make
    (jitted: the eager converter takes ~10 s a tree here), key for key,
    in shape and dtype."""
    from alignq_tpu.kernels.convert import pack_qparams_int4 as jpack
    from alignq_tpu.kernels.infer import convert_resnet20 as jconvert
    from alignq_tpu_torch.kernels.artifact import _leaves
    from alignq_tpu_torch.kernels.convert import pack_qparams_int4
    from alignq_tpu_torch.kernels.infer import convert_resnet20
    from alignq_tpu_torch.tools.artifact_bench import tree_bytes
    from tools.artifact_bench import tree_bytes as jtree_bytes

    params, stats = _resnet20()
    p_np, s_np = _numpy_tree(params), _numpy_tree(stats)
    q8, q4 = convert_resnet20(params, stats), convert_resnet20(params, stats, weight_bits=4, act_bits=4)
    j8 = jax.jit(jconvert)(p_np, s_np)
    j4 = jax.jit(lambda p, s: jpack(jconvert(p, s, weight_bits=4, act_bits=4)))(p_np, s_np)
    for tree in ({"params": params, "batch_stats": stats}, q8, q4, pack_qparams_int4(q4)):
        assert tree_bytes(tree) == jtree_bytes(tree)
    for port, want in ((q8, j8), (pack_qparams_int4(q4), j4)):
        got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in _leaves(port) if torch.is_tensor(v)}
        assert got == {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(want) if v.ndim}


SMOKE = {
    "shape_ceilings": ["--families", "resnet20", "--e2e", "--graph"],
    "model_zoo_bench": ["--families", "resnet20"],
    "serve_bench": [],
    "artifact_bench": [],
    "qat_throughput": [],
    "qat_breakdown": [],
    "stage_calib_ab": ["--calibs", "ema"],
}


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_smoke_on_the_cpu(tool, one_torch_thread, capsys):
    import importlib

    mod = importlib.import_module(f"alignq_tpu_torch.tools.{tool}")
    if tool == "corr_mode_ab":  # its cheapest row in this process: main runs the 2-rank modes too
        with tempfile.TemporaryDirectory() as job:
            out = [mod.run("single", 1, mod.parse_args(["--smoke", "--device", "cpu"]), job)]
    else:
        out = mod.main(["--smoke", "--device", "cpu", *SMOKE[tool]])
        lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
        assert lines[0]["card"] == "cpu (no card)" and len(lines) > 1
    if tool == "shape_ceilings":
        model = out["models"]["resnet20"]
        assert model["n_distinct_shapes"] == 8 and 0 < model["frac_of_achievable"]
        assert model["epilogue_isolated_ms"] > 0 and model["residual_vs_mandatory"] is not None
    elif tool == "model_zoo_bench":
        assert [r["name"] for r in out] == ["resnet20_b8", "resnet20_poly_b8", "resnet20_fast_b8"]
        assert all(r["ms"] > 0 and r["imgs_per_sec"] > 0 for r in out)
    elif tool == "serve_bench":
        assert [r["name"] for r in out] == ["xfer_mbps", "lat_b1", "lat_b8", "stream_b8"]
    elif tool == "artifact_bench":
        assert [r.get("format") for r in out[:4]] == ["f32_params", "w8a8_int8", "w4a4_int8_stored", "w4a4_packed"]
        assert out[3]["raw_bytes"] < out[2]["raw_bytes"] < out[0]["raw_bytes"] and out[4]["logits_equal_unpacked"]
    elif tool == "qat_throughput":
        assert out["batch"] == 8 and not out["admm"] and np.isfinite(out["ms_per_step"])
    elif tool == "qat_breakdown":
        assert [r["name"] for r in out] == ["fwd", "grad", "step", "step_uniform", "step_bf16"]
    elif tool == "corr_mode_ab":
        assert out[0]["mode"] == "single" and len(out[0]["curve"]) == 1
    else:
        assert set(out) == {"clean_max", "ema", "summary"} and out["clean_max"]["amax_inflation_mean"] == 1.0


@pytest.mark.parametrize("tool", TOOLS + ("bench",))
def test_tool_defaults_to_the_card(tool):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    name = "alignq_tpu_torch.bench" if tool == "bench" else f"alignq_tpu_torch.tools.{tool}"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        importlib.import_module(name).main(["--smoke"])
