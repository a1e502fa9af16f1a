"""Epoch-based training driver (port of alignq_tpu/train/loop.py), on one
device: the CUDA card unless the caller asks for the CPU. Data-parallel
meshes and multi-host runs wait for ROADMAP queue 1, Distribution."""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from alignq_tpu_torch.data.loader import Data
from alignq_tpu_torch.device import resolve_device
from alignq_tpu_torch.models import registry as model_registry
from alignq_tpu_torch.train.checkpoint import CheckpointManager
from alignq_tpu_torch.train.config import TrainConfig
from alignq_tpu_torch.train.state import create_train_state
from alignq_tpu_torch.train.steps import make_eval_step, make_train_step
from alignq_tpu_torch.utils.logging_utils import MetricWriter, dump_config, get_logger
from alignq_tpu_torch.utils.meters import AverageMeter


def true_f32() -> None:
    """f32 convs and matmuls in full f32 on CUDA (no TF32): the JAX
    package's Precision.HIGHEST. cuDNN convs default to TF32 otherwise."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def to_device(xb: np.ndarray, yb: np.ndarray, device: torch.device):
    return torch.from_numpy(np.ascontiguousarray(xb)).to(device), torch.from_numpy(yb).to(device).long()


def evaluate(eval_step, state, loader, device) -> dict:
    meters = {"loss": AverageMeter(), "top1": AverageMeter(), "top5": AverageMeter()}
    for xb, yb in loader:
        m = eval_step(state, *to_device(xb, yb, device))
        for k, meter in meters.items():
            meter.update(float(m[k]), len(yb))
    return {k: meter.avg for k, meter in meters.items()}


def fit(cfg: TrainConfig, data: Data, model=None, resume: bool = False, max_steps: Optional[int] = None,
        pretrained_dir: Optional[str] = None, device=None) -> dict:
    """Train per config; returns {'best_top1', 'best_top5', 'state'} (and
    'aborted' where a loss was not finite). model: a model to train, on
    any device (moved to `device`); None builds the config's from its
    seed. pretrained_dir: warm-start the parameters and statistics from
    another run's latest checkpoint (train/pretrained.py); the optimizer
    and the duals stay fresh."""
    if math.prod(cfg.mesh_shape) > 1:
        raise NotImplementedError("meshes (data- and tensor-parallel training) wait for ROADMAP queue 1, "
                                  "Distribution")
    dev = resolve_device(device)
    true_f32()
    logger = get_logger(f"{cfg.job_dir}/logger.log")
    writer_train, writer_test = MetricWriter(cfg.job_dir, "train"), MetricWriter(cfg.job_dir, "test")
    dump_config(cfg, cfg.job_dir)

    gen = torch.Generator().manual_seed(cfg.seed)
    eval_model = None
    if model is None:
        model = model_registry.build_model(cfg, generator=gen)
        if cfg.mxu_bf16:
            # bf16 convs in the train step only: eval, and any export, run
            # the f32 forward on the same weights (an f32 twin of the model)
            eval_model = model_registry.build_model(dataclasses.replace(cfg, mxu_bf16=False)).to(dev)
    model = model.to(dev)
    eval_model = model if eval_model is None else eval_model

    steps_per_epoch = len(data.loader_train)
    state = create_train_state(gen, model, cfg, input_shape=(1, *data.loader_test.x.shape[1:]),
                               steps_per_epoch=steps_per_epoch)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model={cfg.target_model} method={cfg.method} W{cfg.bitW}A{cfg.abitW} admm={cfg.admm} "
                f"params={n_params:,} steps/epoch={steps_per_epoch} device={dev}")
    if pretrained_dir:
        # partial warm start (reference main.py:62-82)
        from alignq_tpu_torch.train.pretrained import load_pretrained

        state = load_pretrained(state, pretrained_dir)
    train_step = make_train_step(model, cfg)
    eval_step = make_eval_step(eval_model, cfg)

    ckpt = CheckpointManager(cfg.job_dir, max_to_keep=1 if cfg.best_only_checkpoint else 3)
    start_epoch = 0
    if resume:
        state, start_epoch = ckpt.restore(state)
        logger.info(f"resumed from epoch {start_epoch}")

    best = {"top1": 0.0, "top5": 0.0}
    total_steps = 0
    try:
        for epoch in range(start_epoch, cfg.num_epochs):
            t0 = time.time()
            loss_m, acc_m = AverageMeter(), AverageMeter()
            for i, (xb, yb) in enumerate(data.loader_train, 1):
                state, metrics = train_step(state, *to_device(xb, yb, dev))
                total_steps += 1
                loss_val = float(metrics["loss"])
                if not np.isfinite(loss_val):
                    # stop instead of training on garbage; the last good
                    # checkpoint supports resume
                    logger.error(f"non-finite loss at epoch {epoch} step {i}: aborting "
                                 f"(resume from the last checkpoint with resume=True)")
                    return {"best_top1": best["top1"], "best_top5": best["top5"], "state": state,
                            "aborted": "non_finite_loss"}
                loss_m.update(loss_val, len(yb))
                acc_m.update(float(metrics["accuracy"]) * 100, len(yb))
                if i % cfg.print_freq == 0:
                    logger.info(f"Epoch[{epoch}]({i}/{steps_per_epoch}) loss {loss_m.val:.4f} ({loss_m.avg:.4f}) "
                                f"top1 {acc_m.val:.2f} ({acc_m.avg:.2f})")
                    writer_train.write(state.step, {"loss": loss_m.val, "top1": acc_m.val})
                if max_steps is not None and total_steps >= max_steps:
                    break

            if (epoch + 1) % cfg.eval_freq_epochs == 0 or epoch == cfg.num_epochs - 1:
                em = evaluate(eval_step, state, data.loader_test, dev)
                em["top1"] *= 100
                em["top5"] *= 100
                best["top1"] = max(best["top1"], em["top1"])
                best["top5"] = max(best["top5"], em["top5"])
                logger.info(f"Epoch[{epoch}] eval top1 {em['top1']:.3f} top5 {em['top5']:.3f} "
                            f"(best {best['top1']:.3f}) [{time.time() - t0:.1f}s]")
                writer_test.write(state.step, em)
                ckpt.save(epoch + 1, state, metrics=em)

            if max_steps is not None and total_steps >= max_steps:
                break
    finally:
        writer_train.close()
        writer_test.close()

    logger.info(f"Best @prec1: {best['top1']:.3f} @prec5: {best['top5']:.3f}")
    return {"best_top1": best["top1"], "best_top5": best["top5"], "state": state}
