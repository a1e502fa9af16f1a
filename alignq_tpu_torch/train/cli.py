"""Command-line training entry point (port of alignq_tpu/train/cli.py: the
same flags, plus --device).

    python -m alignq_tpu_torch.train.cli --target_model resnet20_quant \\
        --method ours --bitW 8 --abitW 8 --lr 0.04 --train_batch_size 128

Trains any of the four CIFAR families (--target_model resnet20_quant,
resnet56_quant, densenet_40_quant, mobile_v2) with any quantizer method
(--method ours, or a baseline: uniform, dorefa, lsq, apot, llsq, bwn,
bwnf, uniform_admm; or fp). Runs on the CUDA card
unless given --device cpu. --pretrained JOB_DIR warm-starts from another
run's latest checkpoint. --native_augment builds the port's native augment
library (data/native_augment.py; a failed build raises) and loads this
run's batches through it; a run without the flag takes numpy's path.

Data-parallel training runs one process per device under torchrun, the
world the --mesh's data axis:

    python -m torch.distributed.run --nproc_per_node 2 -m alignq_tpu_torch.train.cli \
        --mesh 2 --multihost --dataset synthetic --admm

NCCL on the cards, one a rank; --dist_backend gloo lets ranks share a card,
and --device cpu runs gloo on the CPU. --coordinator, --num_processes and
--process_id (or ALIGNQ_COORDINATOR, ALIGNQ_NUM_PROCESSES,
ALIGNQ_PROCESS_ID) launch without torchrun. A 'model' axis (--mesh 4 2:
8 ranks, 4 data-parallel groups of 2 that split each divisible kernel's
output channels) trains tensor-parallel in gather mode.
"""

from __future__ import annotations

import argparse
import dataclasses

from alignq_tpu_torch.data.registry import get_data
from alignq_tpu_torch.dist import multihost
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
    add_dist_args(p, d)
    p.add_argument("--mxu_bf16", action="store_true", help="bf16 conv operands in the train step")
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
    p.add_argument("--deterministic", action="store_true",
                   help="cuDNN's deterministic algorithms, no autotuning: runs of one tree repeat step for step")
    p.add_argument("--native_augment", action="store_true",
                   help="build the port's native crop+flip+normalize library (data/native_augment.py) and load "
                        "this run's batches through it")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    join_world(a)
    if a.deterministic:
        import torch

        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    native_library = None
    if a.native_augment:
        from alignq_tpu_torch.data import native_augment

        native_library = str(native_augment.build())
    a.use_correction = not a.no_correction
    field_names = {f.name for f in dataclasses.fields(TrainConfig)}
    overrides = {k: v for k, v in vars(a).items() if k in field_names}
    if a.mesh is not None:
        overrides["mesh_shape"] = tuple(a.mesh)
        overrides["mesh_axes"] = ("data", "model")[: len(a.mesh)]
    return TrainConfig(**overrides), a.resume, a.max_steps, a.pretrained, a.device, native_library


def add_dist_args(p: argparse.ArgumentParser, d) -> None:
    """The flags of data-parallel and multi-process runs (the JAX
    package's, and --dist_backend)."""
    p.add_argument("--mesh", type=int, nargs="+", default=None, metavar="N",
                   help="device mesh shape, one process a device: --mesh 8 (data-parallel), --mesh 4 2 (a 'model' "
                        "axis of 2: tensor-parallel kernels, corr_mode gather)")
    p.add_argument("--corr_mode", choices=("gather", "local"), default=d.corr_mode,
                   help="ADMM corr under DP: 'gather' = exact global-batch (rows all-gathered), 'local' = "
                        "per-shard block-diagonal duals")
    p.add_argument("--grad_compression", choices=("f32", "bf16", "int8_gather"), default=d.grad_compression,
                   help="gradient all-reduce wire format (corr_mode=local path)")
    p.add_argument("--multihost", action="store_true",
                   help="join a torch.distributed process group before training (torchrun's environment, or "
                        "the rendezvous triple below); --mesh then spans the world")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", choices=multihost.BACKENDS, default=None,
                   help="nccl (default on the card, one card a rank) or gloo (the CPU, or ranks sharing a card)")


def join_world(a) -> None:
    """Join the process group where the flags ask for one; the rank's
    device becomes the run's."""
    if a.multihost or a.coordinator:
        multihost.initialize(a.coordinator, a.num_processes, a.process_id, device=a.device, backend=a.dist_backend)


def main(argv=None) -> dict:
    cfg, resume, max_steps, pretrained, device, native_library = parse_args(argv)
    data = get_data(cfg.dataset, cfg.data_dir, cfg.train_batch_size, cfg.eval_batch_size, cfg.seed, native_library)
    result = fit(cfg, data, resume=resume, max_steps=max_steps, pretrained_dir=pretrained, device=device)
    if multihost.is_primary():
        print(f"best_top1={result['best_top1']:.3f} best_top5={result['best_top5']:.3f}")
    multihost.shutdown()
    return result


if __name__ == "__main__":
    main()
