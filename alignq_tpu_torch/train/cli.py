"""Command-line training entry point (port of alignq_tpu/train/cli.py: the
same flags, plus --device).

    python -m alignq_tpu_torch.train.cli --target_model resnet20_quant \\
        --method ours --bitW 8 --abitW 8 --lr 0.04 --train_batch_size 128

Trains any of the four CIFAR families (--target_model resnet20_quant,
resnet56_quant, densenet_40_quant, mobile_v2) with any quantizer method
(--method ours, or a baseline: uniform, dorefa, lsq, apot, llsq, bwn,
bwnf, uniform_admm; or fp). Runs on the CUDA card
unless given --device cpu. --pretrained JOB_DIR warm-starts from another
run's latest checkpoint. --mesh and --multihost raise: they wait for
ROADMAP queue 1, Distribution.
"""

from __future__ import annotations

import argparse
import dataclasses

from alignq_tpu_torch.data.registry import get_data
from alignq_tpu_torch.train.config import TrainConfig
from alignq_tpu_torch.train.loop import fit


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="AlignQ trainer (PyTorch/CUDA)")
    d = TrainConfig()
    p.add_argument("--target_model", default=d.target_model)
    p.add_argument("--method", default=d.method,
                   help="ours | uniform | dorefa | lsq | apot | llsq | bwn | bwnf | uniform_admm | fp")
    p.add_argument("--bitW", type=int, default=d.bitW)
    p.add_argument("--abitW", type=int, default=d.abitW)
    p.add_argument("--act_range", type=float, default=d.act_range)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--momentum", type=float, default=d.momentum)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--num_epochs", type=int, default=d.num_epochs)
    p.add_argument("--train_batch_size", type=int, default=d.train_batch_size)
    p.add_argument("--eval_batch_size", type=int, default=d.eval_batch_size)
    p.add_argument("--lr_decay_steps", type=int, nargs="+", default=list(d.lr_decay_steps))
    p.add_argument("--lr_gamma", type=float, default=d.lr_gamma)
    p.add_argument("--lam", type=float, default=d.lam)
    p.add_argument("--lam2", type=float, default=d.lam2)
    p.add_argument("--admm", action="store_true")
    p.add_argument("--mesh", type=int, nargs="+", default=None, metavar="N",
                   help="device mesh shape (not ported: ROADMAP queue 1, Distribution)")
    p.add_argument("--corr_mode", choices=("gather", "local"), default=d.corr_mode)
    p.add_argument("--grad_compression", choices=("f32", "bf16", "int8_gather"), default=d.grad_compression)
    p.add_argument("--mxu_bf16", action="store_true", help="bf16 conv operands in the train step")
    p.add_argument("--multihost", action="store_true", help="not ported: ROADMAP queue 1, Distribution")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--cdf_impl", choices=("erf", "poly"), default=d.cdf_impl,
                   help="act-site CDF: 'erf' reference-exact, 'poly' the fast grid (deploy with act_impl='poly')")
    p.add_argument("--variant", default=d.variant,
                   help="quantizer grid: 'b' reference, 'a' raw-Phi, 'int8' deploy grid")
    p.add_argument("--deploy_exact", action="store_true",
                   help="model the INT graph's stem/residual requant sites in QAT (pair with --variant int8)")
    p.add_argument("--stream_int8", action="store_true",
                   help="with --deploy_exact: train the int8-stored residual stream (deploy with stream='int8')")
    p.add_argument("--dataset", default=d.dataset)
    p.add_argument("--data_dir", default=d.data_dir)
    p.add_argument("--job_dir", default=d.job_dir)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--print_freq", type=int, default=d.print_freq)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--pretrained", default=None, metavar="JOB_DIR",
                   help="warm-start from another run's latest checkpoint (parameters and statistics merged by "
                        "name and shape)")
    p.add_argument("--max_steps", type=int, default=None, help="early stop for smoke runs")
    p.add_argument("--no_correction", action="store_true", help="disable the PDF gradient correction")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    if a.multihost or a.coordinator:
        raise NotImplementedError("multi-host training waits for ROADMAP queue 1, Distribution")
    a.use_correction = not a.no_correction
    field_names = {f.name for f in dataclasses.fields(TrainConfig)}
    overrides = {k: v for k, v in vars(a).items() if k in field_names}
    if a.mesh is not None:
        overrides["mesh_shape"] = tuple(a.mesh)
        overrides["mesh_axes"] = ("data", "model")[: len(a.mesh)]
    return TrainConfig(**overrides), a.resume, a.max_steps, a.pretrained, a.device


def main(argv=None) -> dict:
    cfg, resume, max_steps, pretrained, device = parse_args(argv)
    data = get_data(cfg.dataset, cfg.data_dir, cfg.train_batch_size, cfg.eval_batch_size, cfg.seed)
    result = fit(cfg, data, resume=resume, max_steps=max_steps, pretrained_dir=pretrained, device=device)
    print(f"best_top1={result['best_top1']:.3f} best_top5={result['best_top5']:.3f}")
    return result


if __name__ == "__main__":
    main()
