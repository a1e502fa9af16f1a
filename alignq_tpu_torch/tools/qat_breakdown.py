"""Where the ResNet-20 W8A8 QAT step's time goes, one process (port of
tools/qat_breakdown.py). Rows (one JSON line each, ms and images/s):

- fwd: the train-mode forward alone (no gradient; BN statistics move);
- grad: the training loss's gradient with respect to every parameter, no
  optimizer;
- step: the trainer's whole step (forward, backward, PDF-corrected SGD,
  BN statistics), f32 with TF32 off;
- step_uniform: the same step with method 'uniform' (no CDF transform, no
  PDF correction): AlignQ's own math is step less step_uniform;
- step_bf16: the step on bf16 conv operands (TrainConfig.mxu_bf16).

The port's default step is already true f32 (TF32 off, train/loop.py
true_f32), which is what the JAX tool's `step_f32` row measures; the JAX
tool's `step` ran the TPU's DEFAULT precision, bf16 products. So this
tool's contrasting row is the bf16 opt-in, `step_bf16`, the counterpart
of that `step`, and its `step` the counterpart of `step_f32`.

Timed by CUDA events (the median of ITERS calls after WARMUP), on the CPU
by the host clock.

    python -m alignq_tpu_torch.tools.qat_breakdown [--batch 1024] [--cdf_impl erf] [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

ITERS, WARMUP = 10, 3  # timed calls of a row, and the calls before them


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description="cost breakdown of the ResNet-20 W8A8 QAT step")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--cdf_impl", choices=("erf", "poly"), default="erf")
    p.add_argument("--smoke", action="store_true", help="batch 8, one timed call a row")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)

    from alignq_tpu_torch.device import resolve_device
    from alignq_tpu_torch.models.registry import build_model
    from alignq_tpu_torch.tools.qat_throughput import qat_step
    from alignq_tpu_torch.train import TrainConfig
    from alignq_tpu_torch.train.loop import true_f32
    from alignq_tpu_torch.train.steps import cross_entropy_loss
    from alignq_tpu_torch.utils.cuda_timing import time_forward_ms
    from alignq_tpu_torch.utils.launches import device_line

    dev = resolve_device(a.device)
    print(json.dumps({"card": device_line(dev)}), flush=True)
    true_f32()
    batch, iters, warmup = (8, 1, 0) if a.smoke else (a.batch, ITERS, WARMUP)
    cfg = TrainConfig(train_batch_size=batch, bitW=8, abitW=8, cdf_impl=a.cdf_impl)
    rows = []

    def emit(name, fn):
        ms = time_forward_ms(fn, dev, iters, warmup)
        rows.append({"name": name, "batch": batch, "ms": ms, "imgs_per_sec": batch / ms * 1e3})
        print(json.dumps(rows[-1]), flush=True)

    model = build_model(cfg, torch.Generator().manual_seed(0)).to(dev)
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(batch, 32, 32, 3), dtype=torch.float32, device=dev)
    y = torch.tensor(rng.randint(0, 10, batch), device=dev)
    params = [q for q in model.parameters() if q.requires_grad]

    def fwd():
        with torch.no_grad():
            return model(x, train=True)

    def grad():
        return torch.autograd.grad(cross_entropy_loss(model(x, train=True), y), params)

    emit("fwd", fwd)
    emit("grad", grad)
    for name, c in (("step", cfg), ("step_uniform", dataclasses.replace(cfg, method="uniform")),
                    ("step_bf16", dataclasses.replace(cfg, mxu_bf16=True))):
        emit(name, qat_step(c, dev))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"summary": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
