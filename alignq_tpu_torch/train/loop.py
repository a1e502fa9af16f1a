"""Epoch-based training driver (port of alignq_tpu/train/loop.py): the
CUDA card unless the caller asks for the CPU.

A mesh larger than one device (cfg.mesh_shape) trains data-parallel, one
process per device over torch.distributed (dist/multihost.py initialize
first): each rank takes its rows of the global batch that every rank's
seeded loader yields alike, the step runs in cfg.corr_mode
(train/steps.py), eval reduces its meters over the ranks, rank 0 alone
writes the log file, the metrics and the config, and checkpoints are
collective (train/checkpoint.py). A 'model' axis larger than 1 trains
tensor-parallel besides: each rank holds its slice of every divisible
kernel's output channels (dist/sharding.py shard_model), and checkpoints
hold the whole tensors."""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Optional

import numpy as np
import torch

from alignq_tpu_torch.data.loader import Data, to_tensor
from alignq_tpu_torch.device import resolve_device
from alignq_tpu_torch.dist import multihost
from alignq_tpu_torch.dist.collectives import mean_over
from alignq_tpu_torch.dist.sharding import replicated, shard_batch
from alignq_tpu_torch.models import registry as model_registry
from alignq_tpu_torch.train.checkpoint import CheckpointManager
from alignq_tpu_torch.train.config import TrainConfig
from alignq_tpu_torch.train.state import create_train_state
from alignq_tpu_torch.train.steps import check_mesh, make_eval_step, make_train_step
from alignq_tpu_torch.utils.logging_utils import MetricWriter, dump_config, get_logger
from alignq_tpu_torch.utils.meters import AverageMeter


def true_f32() -> None:
    """f32 convs and matmuls in full f32 on CUDA (no TF32): the JAX
    package's Precision.HIGHEST. cuDNN convs default to TF32 otherwise."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def to_device(xb, yb, device: torch.device, dtype: Optional[torch.dtype] = None):
    """A batch on `device`: the images (in `dtype`, where given) and the
    labels as int64; pinned host memory is copied without blocking."""
    return to_tensor(xb, device, dtype), to_tensor(yb, device).long()


def evaluate(eval_step, state, loader, device, mesh=None) -> dict:
    """Loss, top-1 and top-5 over the loader. Over a mesh each rank
    evaluates its rows of a batch and the means are averaged over the
    ranks; a batch the ranks do not divide is evaluated whole on every
    rank and counted once."""
    dtype = next(state.model.parameters()).dtype
    axis = mesh.batch_axis() if mesh is not None else None
    meters = {"loss": AverageMeter(), "top1": AverageMeter(), "top5": AverageMeter()}
    for xb, yb in loader:
        split = axis is not None and len(yb) % axis.size == 0
        if split:
            m = eval_step(state, *to_device(*shard_batch((xb, yb), mesh), device, dtype))
            m = dict(zip(meters, mean_over(torch.stack([m[k].double() for k in meters]), axis.group).unbind()))
        else:
            m = eval_step(state, *to_device(xb, yb, device, dtype))
        for k, meter in meters.items():
            meter.update(float(m[k]), len(yb))
    return {k: meter.avg for k, meter in meters.items()}


def _build_distributed(cfg: TrainConfig, model, state, eval_model=None):
    """The mesh, the state (local mode: this rank's duals; a model axis:
    this rank's slices, the optimizer told which) and the step of a
    distributed run. JAX's refusals come first and need no process group:
    a train batch the data axis does not divide, a 'local' mode with a
    model axis. eval_model: an f32 twin of the model, placed alike."""
    from alignq_tpu_torch.dist import make_mesh
    from alignq_tpu_torch.dist.corr import create_local_duals
    from alignq_tpu_torch.dist.sharding import shard_model

    shape = tuple(cfg.mesh_shape)
    n_data = shape[0]
    if cfg.train_batch_size % n_data:
        raise ValueError(f"train_batch_size {cfg.train_batch_size} not divisible by data-axis size {n_data}")
    check_mesh(math.prod(shape[1:]), cfg.corr_mode)
    mesh = make_mesh(shape, tuple(cfg.mesh_axes))
    replicated({**state.params, **state.batch_stats}, mesh)
    state.tx.shards = {k: (v.axis, v.dim) for k, v in shard_model(model, mesh).items()}
    if eval_model is not None and eval_model is not model:
        shard_model(eval_model, mesh)
    if cfg.corr_mode == "local" and cfg.admm:
        p = next(model.parameters())
        state.admm_duals = create_local_duals(torch.Generator().manual_seed(cfg.seed + 1), sorted(state.admm_duals),
                                              cfg, n_data, mesh.rank, p.dtype, p.device)
    return mesh, state, make_train_step(model, cfg, mesh)


def _observability(cfg):
    """The run's logger and metric writers: rank 0 writes job_dir/logger.log,
    the metric streams and the config dump; rank p logs warnings and worse
    to job_dir/logger.p{p}.log and writes no metrics."""
    primary = multihost.is_primary()
    logger = get_logger(f"{cfg.job_dir}/{'logger.log' if primary else f'logger.p{multihost.process_index()}.log'}")
    if not primary:
        logger.setLevel(logging.WARNING)
        return logger, None, None
    dump_config(cfg, cfg.job_dir)
    return logger, MetricWriter(cfg.job_dir, "train"), MetricWriter(cfg.job_dir, "test")


def fit(cfg: TrainConfig, data: Data, model=None, resume: bool = False, max_steps: Optional[int] = None,
        pretrained_dir: Optional[str] = None, device=None) -> dict:
    """Train per config; returns {'best_top1', 'best_top5', 'state'} (and
    'aborted' where a loss was not finite). model: a model to train, on
    any device (moved to `device`); None builds the config's from its
    seed. pretrained_dir: warm-start the parameters and statistics from
    another run's latest checkpoint (train/pretrained.py); the optimizer
    and the duals stay fresh."""
    dev = resolve_device(device)
    true_f32()
    logger, writer_train, writer_test = _observability(cfg)

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

    dtype = next(model.parameters()).dtype
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
    mesh = None
    if math.prod(cfg.mesh_shape) > 1:
        mesh, state, train_step = _build_distributed(cfg, model, state, eval_model)
        logger.info(f"mesh {mesh.shape} rank {mesh.rank} corr_mode={cfg.corr_mode} "
                    f"grad_compression={cfg.grad_compression}")
        if cfg.corr_mode == "gather" and cfg.grad_compression != "f32":
            logger.warning("grad_compression applies to corr_mode='local'; gather mode reduces in f32, as the JAX "
                           "package's GSPMD step")
    else:
        train_step = make_train_step(model, cfg)
    eval_step = make_eval_step(eval_model, cfg)
    for loader in (data.loader_train, data.loader_test):
        loader.pin_memory = dev.type == "cuda"

    ckpt = CheckpointManager(cfg.job_dir, max_to_keep=1 if cfg.best_only_checkpoint else 3, mesh=mesh,
                             local_duals=cfg.corr_mode == "local")
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
                rows = (xb, yb) if mesh is None else shard_batch((xb, yb), mesh)
                state, metrics = train_step(state, *to_device(*rows, dev, dtype))
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
                    if writer_train is not None:
                        writer_train.write(state.step, {"loss": loss_m.val, "top1": acc_m.val})
                if max_steps is not None and total_steps >= max_steps:
                    break

            if (epoch + 1) % cfg.eval_freq_epochs == 0 or epoch == cfg.num_epochs - 1:
                em = evaluate(eval_step, state, data.loader_test, dev, mesh)
                em["top1"] *= 100
                em["top5"] *= 100
                best["top1"] = max(best["top1"], em["top1"])
                best["top5"] = max(best["top5"], em["top5"])
                logger.info(f"Epoch[{epoch}] eval top1 {em['top1']:.3f} top5 {em['top5']:.3f} "
                            f"(best {best['top1']:.3f}) [{time.time() - t0:.1f}s]")
                if writer_test is not None:
                    writer_test.write(state.step, em)
                ckpt.save(epoch + 1, state, metrics=em)

            if max_steps is not None and total_steps >= max_steps:
                break
    finally:
        for w in (writer_train, writer_test):
            if w is not None:
                w.close()

    logger.info(f"Best @prec1: {best['top1']:.3f} @prec5: {best['top5']:.3f}")
    return {"best_top1": best["top1"], "best_top5": best["top5"], "state": state}
