"""Images/s of the ResNet-20 W8A8 QAT train step (port of
tools/qat_throughput.py): forward, backward, the PDF-corrected optimizer
and, with --admm, the ADMM duals, the step the trainer runs
(train/steps.py make_train_step), TF32 off (train/loop.py true_f32).
--bf16 runs the convs on bf16 operands (TrainConfig.mxu_bf16, the
models' mxu_dtype=torch.bfloat16). The step is timed by CUDA events (the
median of --iters steps after warm-up; utils/cuda_timing.py median_ms),
on the CPU by the host clock.

    python -m alignq_tpu_torch.tools.qat_throughput [--batch 1024] [--admm] [--bf16] [--cdf_impl erf|poly]
        [--smoke] [--device cpu]

prints {"name": "qat_step", "batch", "admm", "bf16", "cdf_impl",
"ms_per_step", "imgs_per_sec"}.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def qat_step(cfg, dev, seed: int = 0):
    """A call of one train step of the config's model on a batch of random
    images and labels from a seed."""
    from alignq_tpu_torch.models.registry import build_model
    from alignq_tpu_torch.train import create_train_state, make_train_step

    model = build_model(cfg, torch.Generator().manual_seed(seed)).to(dev)
    state = create_train_state(torch.Generator().manual_seed(seed), model, cfg, steps_per_epoch=391)
    step = make_train_step(model, cfg)
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(cfg.train_batch_size, 32, 32, 3), dtype=torch.float32, device=dev)
    y = torch.tensor(rng.randint(0, 10, cfg.train_batch_size), device=dev)
    return lambda: step(state, x, y)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="QAT train-step images/s, ResNet-20 W8A8")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--admm", action="store_true")
    p.add_argument("--bf16", action="store_true", help="bf16 conv operands (TrainConfig.mxu_bf16)")
    p.add_argument("--cdf_impl", choices=("erf", "poly"), default="erf")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--smoke", action="store_true", help="batch 8, one timed step")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)

    from alignq_tpu_torch.device import resolve_device
    from alignq_tpu_torch.train import TrainConfig
    from alignq_tpu_torch.train.loop import true_f32
    from alignq_tpu_torch.utils.cuda_timing import time_forward_ms
    from alignq_tpu_torch.utils.launches import device_line

    dev = resolve_device(a.device)
    print(json.dumps({"card": device_line(dev)}), flush=True)
    true_f32()
    batch, iters = (8, 1) if a.smoke else (a.batch, a.iters)
    cfg = TrainConfig(train_batch_size=batch, bitW=8, abitW=8, admm=a.admm, cdf_impl=a.cdf_impl, mxu_bf16=a.bf16)
    ms = time_forward_ms(qat_step(cfg, dev), dev, iters, 0 if a.smoke else 3)
    row = {"name": "qat_step", "batch": batch, "admm": a.admm, "bf16": a.bf16, "cdf_impl": a.cdf_impl,
           "ms_per_step": ms, "imgs_per_sec": batch / ms * 1e3}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
