"""Train -> freeze -> INT8 export -> agreement, for the domain-adaptation
families (port of tools/export_da_int8.py).

Trains a small DA net (the digit DANN, or a DANN, DSAN or MDD net on an
ImageNet-layout trunk; the synthetic domains where no dataset is on disk),
folds it with its family's converter (kernels/deploy_registry.py: digit_dann,
dann, dsan, mdd) and runs the INT graph and the fake-quant eval on the
target test set: their top-1s, the delta, the prediction agreement and the
logit margins of the images where they disagree (export_int8's report).

    python -m alignq_tpu_torch.export_da_int8 --task digit --epochs 2
    python -m alignq_tpu_torch.export_da_int8 --task dsan --arch resnet18 --image_size 64

Runs on the CUDA card unless given --device cpu (on the card every conv of
the INT graph is a K1 launch: the digit net's two 5x5 convs, the trunks'
stems and blocks). --seed seeds the init, the duals and the dropout; the
data keep the JAX tool's seeds (digits 0, Office 1). --save writes the
frozen INT artifact that serve.engine_from_artifact serves.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from alignq_tpu_torch.export_int8 import export_and_compare
from alignq_tpu_torch.train.da import DAConfig, fit_dann, fit_dsan, fit_mdd

# the prediction head of each task's fake-quant eval
FAKE_QUANT = {
    "digit": lambda m, x: m(x, 0.0, train=False)[0],
    "dann": lambda m, x: m(x, 0.0, train=False)[0],
    "dsan": lambda m, x: m(x, train=False),
    "mdd": lambda m, x: m(x, 0.0, train=False)[1],  # `outputs`, fit_mdd's eval head
}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="DA QAT -> INT8 export and its agreement (PyTorch/CUDA)")
    p.add_argument("--task", choices=["digit", "dann", "dsan", "mdd"], default="digit")
    p.add_argument("--arch", default="resnet18")
    p.add_argument("--bits", type=int, default=8)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--image_size", type=int, default=64, help="office tasks")
    p.add_argument("--img_size", type=int, default=28, help="digit task")
    p.add_argument("--src_data", default=None)
    p.add_argument("--tgt_data", default=None)
    p.add_argument("--data_dir", default="data")
    p.add_argument("--job_dir", default=os.path.join(tempfile.gettempdir(), "alignq_export_da"))
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--lr", type=float, default=None, help="override DAConfig.lr (default 1e-3)")
    p.add_argument("--save", default=None, metavar="PATH.npz", help="save the frozen INT artifact")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    p.add_argument("--seed", type=int, default=0, help="seed of the init, the duals and the dropout")
    a = p.parse_args(argv)

    bits, gen = a.bits, torch.Generator().manual_seed(a.seed)
    q = dict(w_bit=bits, a_bit=bits, method="ours", variant="int8", generator=gen)
    cfg = DAConfig(train_batch_size=a.batch, eval_batch_size=a.batch, bitW=bits, abitW=bits, num_epochs=a.epochs,
                   job_dir=a.job_dir, correction_exclude=(), seed=a.seed, **({"lr": a.lr} if a.lr is not None else {}))
    meta = {"model": "digit_dann" if a.task == "digit" else a.task, "weight_bits": bits, "act_bits": bits,
            "act_impl": "erf"}
    if a.task == "digit":
        from alignq_tpu_torch.data.digits import get_digit_domain
        from alignq_tpu_torch.models import MNISTModelQuant

        src, tgt = a.src_data or "mnist", a.tgt_data or "mnistm"
        loaders = {key: get_digit_domain(dom, a.data_dir, a.batch, train=train, img_size=a.img_size)
                   for key, dom, train in (("src_train", src, True), ("tgt_train", tgt, True),
                                           ("src_test", src, False), ("tgt_test", tgt, False))}
        cfg = dataclasses.replace(cfg, num_classes=10, use_correction=False)
        result = fit_dann(cfg, loaders, MNISTModelQuant(img_size=a.img_size, **q), a.max_steps, a.device)
        meta["img_size"] = a.img_size
    else:
        from alignq_tpu_torch.data.office import get_office_pair
        from alignq_tpu_torch.models import DANN, DSAN, MDDNet

        loaders = get_office_pair(a.data_dir, a.src_data or "dslr", a.tgt_data or "webcam", a.batch, a.batch,
                                  image_size=a.image_size)
        cfg = dataclasses.replace(cfg, num_classes=31)
        if a.task == "dann":
            result = fit_dann(cfg, loaders, DANN(arch=a.arch, num_classes=31, **q), a.max_steps, a.device)
        elif a.task == "dsan":
            result = fit_dsan(cfg, loaders, DSAN(arch=a.arch, num_classes=31, bottle_neck=True, **q), a.max_steps,
                              a.device)
            meta["bottle_neck"] = 1
        else:
            result = fit_mdd(cfg, loaders, MDDNet(arch=a.arch, num_classes=31, **q), a.max_steps, a.device)
        meta.update(arch=a.arch, image_size=a.image_size, num_classes=31)
    print(f"trained: best_tgt_top1={result['best_tgt_top1']:.2f}")

    model = result["state"].model
    report, qparams = export_and_compare(model, loaders["tgt_test"], meta["model"], meta, FAKE_QUANT[a.task])
    print(f"tgt INT{bits} top1: {report['int_top1']:.2f}  fake-quant top1: {report['fq_top1']:.2f}  "
          f"prediction agreement: {report['agreement']:.2f}%")
    print(f"deployment accuracy delta (fake-quant - int): {report['delta']:+.2f} pts")
    if report["disagree_margins"]:
        print(f"logit margins (fake-quant, INT) of the {len(report['disagree_margins'])} images that disagree: "
              f"{report['disagree_margins']}; median fake-quant top-1 less top-2 margin {report['median_margin']:.4g}; "
              f"largest INT - fake-quant logit gap {report['max_logit_gap']:.4g} "
              f"(median {report['median_logit_gap']:.4g})")
    if a.save:
        from alignq_tpu_torch.kernels.artifact import save_int8_artifact

        save_int8_artifact(a.save, qparams, meta=meta)
        print(f"saved INT artifact -> {a.save}")
    return {**report, "state": result["state"], "model": model, "qparams": qparams, "meta": meta,
            "best_tgt_top1": result["best_tgt_top1"]}


if __name__ == "__main__":
    main()
