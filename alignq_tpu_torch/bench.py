"""Headline benchmark of the port: ResNet-20 CIFAR-10 INT8 inference,
images/s on one CUDA card.

    python -m alignq_tpu_torch.bench [--smoke] [--device cpu]

Prints ONE JSON line: {"metric", "value", "unit": "images/sec", "batch",
"vs_baseline", "device"} and bench.py's companion keys beside them,
measured in the same process at the same batch on the card
(ceiling_keys): "frac_of_achievable", "frac_of_nominal",
"conv_ceiling_ms", "epilogue_isolated_ms", "residual_vs_mandatory"; null
under --device cpu, where there is no card.

Benched path: the configuration the JAX package's bench.py benches, the
true-INT8 graph (kernels/infer.py resnet20_int8_forward) of W8A8 ResNet-20
at batch 2048 with the poly act grid (act_impl='poly') and the int8
residual stream (stream='int8'), K3 off; random weights from a seed, the
kernels' operands laid out once, as an engine does. On the card the
value comes from CUDA events around one forward, the median of 20 after
warm-up. --device cpu runs the kernels' plain versions and times them on
the host clock (`device` then says "cpu": such a value is no card's).

vs_baseline is bench.py's ratio: the graph's analytic conv operations
(2 * k * k * Cin * Cout * Ho * Wo over the topology, and the head) over
the time, over the card's dense int8 peak, over the 0.90 target fraction.
The peak is an NVIDIA H100 SXM's 1,979 TOP/s (its data sheet), not the
TPU's figure that bench.py uses. --smoke runs batch 64 and 3 timed
forwards, for the CPU test.
"""

from __future__ import annotations

import argparse
import json

import torch

from alignq_tpu_torch.utils.cuda_timing import time_forward_ms

PEAK_INT8_OPS_PER_S = 1979e12  # NVIDIA H100 SXM, dense int8 tensor-core rate
TARGET_ROOFLINE_FRACTION = 0.90  # the north-star fraction of bench.py
METRIC = "resnet20_cifar10_int8_inference_images_per_sec_per_chip"

# PreAct ResNet-20's distinct convs: (count, cin, cout, in_hw, ksize, stride)
RESNET20_CONVS = (
    (1, 3, 16, 32, 3, 1),  # stem
    (6, 16, 16, 32, 3, 1),  # stage 1
    (1, 16, 32, 32, 3, 2),  # stage 2's first conv0
    (1, 16, 32, 32, 1, 2),  # stage 2's skip
    (5, 32, 32, 16, 3, 1),  # stage 2
    (1, 32, 64, 16, 3, 2),  # stage 3's first conv0
    (1, 32, 64, 16, 1, 2),  # stage 3's skip
    (5, 64, 64, 8, 3, 1),  # stage 3
)


def resnet20_analytic_ops(batch: int) -> float:
    """2 * k * k * Cin * Cout * Ho * Wo summed over the topology, and the head."""
    ops = 2 * 64 * 10
    for cnt, cin, cout, hw, k, s in RESNET20_CONVS:
        ops += cnt * 2 * k * k * cin * cout * (hw // s) * (hw // s)
    return float(ops * batch)


def ceiling_keys(fwd, ms: float, nominal: float, batch: int, dev: torch.device) -> dict:
    """bench.py's companion keys, measured on the card in this process at
    the bench's batch (tools/shape_ceilings.py): frac_of_achievable, the
    conv ceiling (each distinct conv of the graph alone, by graph_ms, times
    its count) over the forward's ms; frac_of_nominal, the analytic ops'
    share of the int8 peak; conv_ceiling_ms; epilogue_isolated_ms, what the
    graph runs outside its kernels (shape_ceilings.epilogue_ops: the
    casts onto and off the int16 stream, the relus, the scaled shortcuts,
    the residual adds, the block-edge requants, the pool and head), each op
    alone; residual_vs_mandatory, (ms - conv ceiling) over it. On the CPU
    each is None: no card."""
    keys = ("frac_of_achievable", "frac_of_nominal", "conv_ceiling_ms", "epilogue_isolated_ms",
            "residual_vs_mandatory")
    if dev.type != "cuda":
        return dict.fromkeys(keys)
    from alignq_tpu_torch.tools.shape_ceilings import ceiling, conv_inventory, preact_graph_ceiling

    conv_ms, _ = ceiling(conv_inventory(fwd))
    epilogue_ms = preact_graph_ceiling(20, batch, conv_ms, dev)["epilogue_ms"]
    return dict(zip(keys, (round(conv_ms / ms, 4), round(nominal, 4), round(conv_ms, 4), round(epilogue_ms, 4),
                           round((ms - conv_ms) / epilogue_ms, 4))))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="ResNet-20 INT8 inference images/s (PyTorch/CUDA)")
    p.add_argument("--smoke", action="store_true", help="batch 64 and 3 timed forwards")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)

    from alignq_tpu_torch.device import resolve_device
    from alignq_tpu_torch.kernels.infer import build_resnet20_int8, pack_int8_operands, resnet20_int8_forward

    dev = resolve_device(a.device)
    batch, runs, warmup = (64, 3, 1) if a.smoke else (2048, 20, 3)
    _, (qparams, x) = build_resnet20_int8(batch, device=dev)
    operands = pack_int8_operands(qparams)

    def fwd():
        with torch.inference_mode():
            return resnet20_int8_forward(qparams, x, act_impl="poly", stream="int8", operands=operands)

    ms = time_forward_ms(fwd, dev, runs, warmup)
    nominal = resnet20_analytic_ops(batch) / (ms * 1e-3) / PEAK_INT8_OPS_PER_S
    row = {
        "metric": METRIC,
        "value": round(batch / ms * 1e3, 1),
        "unit": "images/sec",
        "batch": batch,
        "vs_baseline": round(nominal / TARGET_ROOFLINE_FRACTION, 4),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    row.update(ceiling_keys(fwd, ms, nominal, batch, dev))
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
