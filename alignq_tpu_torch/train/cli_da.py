"""Domain-adaptation command line (port of alignq_tpu/train/cli_da.py: the
same flags, plus --device).

    python -m alignq_tpu_torch.train.cli_da --task dann --src_data dslr --tgt_data webcam --bitW 8 --admm
    python -m alignq_tpu_torch.train.cli_da --task dsan --src_data amazon --tgt_data webcam --bitW 4
    python -m alignq_tpu_torch.train.cli_da --task digit --src_data mnist --tgt_data mnistm
    python -m alignq_tpu_torch.train.cli_da --task mdd --src_data amazon --tgt_data webcam --bitW 8

Runs on the CUDA card unless given --device cpu. Data-parallel runs take
the training CLI's flags (train/cli.py: one process per device under
torchrun, --mesh N --multihost), in gather mode only.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from alignq_tpu_torch.dist import multihost
from alignq_tpu_torch.train.cli import add_dist_args, join_world
from alignq_tpu_torch.train.da import DAConfig, fit_dann, fit_dsan, fit_mdd


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="AlignQ domain-adaptation trainer (PyTorch/CUDA)")
    d = DAConfig()
    p.add_argument("--task", choices=["dann", "dsan", "mdd", "digit"], default="dann")
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--method", default=d.method)
    p.add_argument("--bitW", type=int, default=d.bitW)
    p.add_argument("--abitW", type=int, default=d.abitW)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--train_batch_size", type=int, default=28)
    p.add_argument("--eval_batch_size", type=int, default=28)
    p.add_argument("--num_epochs", type=int, default=d.num_epochs)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--src_data", default=d.src_data)
    p.add_argument("--tgt_data", default=d.tgt_data)
    p.add_argument("--param", type=float, default=d.param)
    p.add_argument("--srcweight", type=float, default=d.srcweight, help="MDD source-margin weight (models/mdd.py)")
    p.add_argument("--bottle_neck", action="store_true", default=True)
    p.add_argument("--img_size", type=int, default=d.img_size)
    p.add_argument("--image_size", type=int, default=224, help="office image size")
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--admm", action="store_true")
    p.add_argument("--cdf_impl", choices=("erf", "poly"), default=d.cdf_impl,
                   help="act-site CDF grid (deploy with the same act_impl)")
    p.add_argument("--stage", default=d.stage, choices=["quant", "align"],
                   help="'align' = FP32 CDF-only ablation (the reference DSAN's default)")
    p.add_argument("--data_dir", default=d.data_dir)
    p.add_argument("--job_dir", default=d.job_dir)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--max_steps", type=int, default=None)
    add_dist_args(p, d)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    join_world(a)
    num_classes = a.num_classes or (10 if a.task == "digit" else 31)
    field_names = {f.name for f in dataclasses.fields(DAConfig)}
    overrides = {k: v for k, v in vars(a).items() if k in field_names and k != "num_classes"}
    if a.mesh is not None:
        overrides["mesh_shape"] = tuple(a.mesh)
        overrides["mesh_axes"] = ("data", "model")[: len(a.mesh)]
    cfg = DAConfig(**overrides, num_classes=num_classes)
    gen = torch.Generator().manual_seed(a.seed)
    q = dict(w_bit=a.bitW, a_bit=a.abitW, method=a.method, admm=a.admm, generator=gen)

    if a.task == "digit":
        from alignq_tpu_torch.data.digits import get_digit_domain
        from alignq_tpu_torch.models import MNISTModelQuant

        loaders = {key: get_digit_domain(dom, a.data_dir, a.train_batch_size, train=train, img_size=a.img_size,
                                         seed=a.seed)
                   for key, dom, train in (("src_train", a.src_data, True), ("tgt_train", a.tgt_data, True),
                                           ("src_test", a.src_data, False), ("tgt_test", a.tgt_data, False))}
        model = MNISTModelQuant(cdf_impl=a.cdf_impl, img_size=a.img_size, **q)
        # the digit driver's plain SGD
        result = fit_dann(dataclasses.replace(cfg, use_correction=False), loaders, model, a.max_steps, a.device)
    else:
        from alignq_tpu_torch.data.office import get_office_pair

        loaders = get_office_pair(a.data_dir, a.src_data, a.tgt_data, a.train_batch_size, a.eval_batch_size,
                                  seed=a.seed, image_size=a.image_size)
        if a.task == "dann":
            from alignq_tpu_torch.models import DANN

            model = DANN(arch=a.arch, num_classes=num_classes, stage=a.stage, cdf_impl=a.cdf_impl, **q)
            result = fit_dann(cfg, loaders, model, a.max_steps, a.device)
        elif a.task == "mdd":
            from alignq_tpu_torch.models import MDDNet

            model = MDDNet(arch=a.arch, num_classes=num_classes, **q)
            result = fit_mdd(cfg, loaders, model, a.max_steps, a.device)
        else:
            from alignq_tpu_torch.models import DSAN

            model = DSAN(arch=a.arch, num_classes=num_classes, bottle_neck=a.bottle_neck, stage=a.stage,
                         cdf_impl=a.cdf_impl, **q)
            result = fit_dsan(cfg, loaders, model, a.max_steps, a.device)
    if multihost.is_primary():
        print(f"best_tgt_top1={result['best_tgt_top1']:.3f}")
    multihost.shutdown()
    return result


if __name__ == "__main__":
    main()
