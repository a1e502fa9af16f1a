"""Train -> freeze -> INT8 export -> accuracy delta (port of
tools/export_int8.py, for the four CIFAR families).

Trains the model with CDF QAT (`train/loop.py fit`), folds the trained
weights and statistics with the family's converter, and runs the family's
INT graph on the test set with its operands laid out once
(`kernels/deploy_registry.py`: on the card K1's convs, the depthwise
kernel, the BN-act passes and, with --stage_kernel, K3), then reports
fake-quant top-1, INT top-1, their delta and the two forwards' prediction
agreement, with the logit margins of the images where they disagree.

    python -m alignq_tpu_torch.export_int8 --dataset synthetic --epochs 2 \\
        --deploy_exact --cdf_impl poly --stage_kernel
    python -m alignq_tpu_torch.export_int8 --model densenet40 --stage_int8
    python -m alignq_tpu_torch.export_int8 --model mobilenetv2 --deploy_exact --lr 0.01 --warmup_epochs 1

Runs on the CUDA card unless given --device cpu. --resume exports the run
already trained in --job_dir (its latest checkpoint) instead of training.
--save writes the frozen INT artifact that serve.engine_from_artifact
serves; with --bits 4, --pack_int4 packs a PreAct ResNet's conv kernels
two codes a byte.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from alignq_tpu_torch.dist.sharding import whole_model
from alignq_tpu_torch.interop import deploy_tree
from alignq_tpu_torch.kernels.deploy_registry import DEPLOY_FAMILIES
from alignq_tpu_torch.kernels.infer import augment_int_cutpoints

# --model -> (TrainConfig.target_model, the convs the PDF correction skips)
FAMILIES = {
    "resnet20": ("resnet20_quant", ("conv0",)),
    "resnet56": ("resnet56_quant", ("conv0",)),
    # the DenseNet and MobileNet drivers correct every conv, the stem's too
    "densenet40": ("densenet_40_quant", ()),
    "mobilenetv2": ("mobile_v2", ()),
}
PREACT = ("resnet20", "resnet56")


def int_forward_kwargs(bits: int, cdf_impl: str, deploy_act_impl: str, stream: str, stage_kernel: bool) -> dict:
    """The INT graph's knobs for a net trained with these options; raises
    where the pairing would not be the trained semantics."""
    impl = cdf_impl if deploy_act_impl == "same" else deploy_act_impl
    if impl in ("bins", "bins_int"):
        if cdf_impl != "erf" or bits > 4:
            raise ValueError("--deploy_act_impl bins/bins_int pairs with --cdf_impl erf, bits <= 4")
    elif impl != cdf_impl:
        raise ValueError("poly/erf deploy must match the QAT grid (--cdf_impl)")
    if stage_kernel and impl != "poly":
        raise ValueError("--stage_kernel requires the poly grid")
    kw = {"act_bits": bits, "act_impl": impl, "stream": stream}
    if stage_kernel:
        kw["use_stage_kernel"] = True
    return kw


def export_and_compare(model: torch.nn.Module, loader, family: str, meta: Dict[str, Any],
                       fake_quant: Optional[Callable] = None) -> Tuple[Dict[str, float], Any]:
    """Fold the trained model into the INT graph of the deploy family that
    `meta` (an artifact's meta: bits, act_impl, stream, stage_int8,
    use_stage_kernel) describes, and run both on every batch of loader, on
    the model's device. fake_quant(model, x): the model's eval logits
    (default model(x, train=False); a domain-adaptation net's class
    logits). Returns ({'fq_top1', 'int_top1', 'delta',
    'agreement'} in percent, 'disagree_margins': for each image where the
    two predictions differ, (the fake-quant logit of its own top class less
    that of the INT graph's, the INT graph's logit of its top class less
    that of the fake-quant's), 'median_margin': the median over the set of
    the fake-quant top-1 less top-2 logit, 'max_logit_gap' and
    'median_logit_gap': the largest and the median over the set of an
    image's largest |INT logit - fake-quant logit|; qparams). A
    column-parallel model (a tensor-parallel fit's) is folded whole:
    every model rank calls this, and each gets the whole network's."""
    model = whole_model(model)
    dev = next(model.parameters()).device
    fam = DEPLOY_FAMILIES[family]
    qparams = fam.convert(*deploy_tree(model), meta)
    eval_qp = augment_int_cutpoints(qparams, meta["act_bits"]) if meta["act_impl"] == "bins_int" else qparams
    int_forward = functools.partial(fam.forward(meta), operands=fam.operands(eval_qp, meta))
    correct = fq_correct = agree = total = 0
    disagree, margins, gaps = [], [], []
    with torch.no_grad():
        for xb, yb in loader:
            x = torch.from_numpy(np.ascontiguousarray(xb)).to(dev)
            l_i8 = int_forward(eval_qp, x).double().cpu().numpy()
            l_fq = (model(x, train=False) if fake_quant is None else fake_quant(model, x)).double().cpu().numpy()
            pred_i8, pred_fq = l_i8.argmax(-1), l_fq.argmax(-1)
            y = np.asarray(yb)
            correct += int((pred_i8 == y).sum())
            fq_correct += int((pred_fq == y).sum())
            agree += int((pred_i8 == pred_fq).sum())
            total += len(y)
            top2 = np.sort(l_fq, axis=-1)[:, -2:]
            margins += (top2[:, 1] - top2[:, 0]).tolist()
            gaps += np.abs(l_i8 - l_fq).max(-1).tolist()
            for i in np.flatnonzero(pred_i8 != pred_fq):
                disagree.append((float(l_fq[i, pred_fq[i]] - l_fq[i, pred_i8[i]]),
                                 float(l_i8[i, pred_i8[i]] - l_i8[i, pred_fq[i]])))
    out = {"fq_top1": 100 * fq_correct / total, "int_top1": 100 * correct / total,
           "delta": 100 * (fq_correct - correct) / total, "agreement": 100 * agree / total,
           "disagree_margins": disagree, "median_margin": float(np.median(margins)),
           "max_logit_gap": float(np.max(gaps)), "median_logit_gap": float(np.median(gaps))}
    return out, qparams


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="QAT -> INT8 export and its accuracy delta (PyTorch/CUDA)")
    p.add_argument("--model", default="resnet20", choices=list(FAMILIES))
    p.add_argument("--bits", type=int, default=8, choices=[8, 4], help="W/A bit width")
    p.add_argument("--variant", default="int8",
                   help="quantizer variant: 'int8' trains on the exact deployment grid; 'b' the reference grid")
    p.add_argument("--cdf_impl", choices=("erf", "poly"), default="erf",
                   help="act-site CDF in BOTH QAT and the INT graph")
    p.add_argument("--deploy_act_impl", choices=("same", "erf", "poly", "bins", "bins_int"), default="same",
                   help="act-site impl in the INT graph only (default: follow --cdf_impl)")
    p.add_argument("--deploy_exact", action="store_true",
                   help="deploy-exact QAT: the INT graph's requant sites in training (the ResNets: stem and block "
                        "inputs; mobilenetv2: stem and the signed m=2 block edges; densenet40: the stem)")
    p.add_argument("--stage_int8", action="store_true",
                   help="densenet40 only: the int8 stage buffer, its calibrated per-channel requant trained "
                        "through (StageRequant); implies --deploy_exact")
    p.add_argument("--stage_calib", choices=("max", "ema", "ema_p999"), default="ema",
                   help="StageRequant calibrator for --stage_int8")
    p.add_argument("--stream", choices=("int16", "int8"), default="int16",
                   help="residual-stream storage in a PreAct ResNet's INT graph ('int8' needs --deploy_exact)")
    p.add_argument("--stage_kernel", action="store_true",
                   help="a PreAct ResNet's runs of identity blocks through K3 (poly)")
    p.add_argument("--save", default=None, metavar="PATH.npz", help="save the frozen INT artifact")
    p.add_argument("--pack_int4", action="store_true",
                   help="with --save and --bits 4, a PreAct ResNet: nibble-pack the conv kernels (halves their "
                        "bytes); engine_from_artifact unpacks them once at load")
    p.add_argument("--admm", action="store_true", help="train with the ADMM correlation loss")
    p.add_argument("--mxu_bf16", action="store_true",
                   help="bf16 convs in the train step only; the agreement and the export run the f32 forward "
                        "on the trained weights")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=None,
                   help="override TrainConfig.lr (0.04); MobileNet-V2 diverges from scratch at it: use --lr 0.01 "
                        "--warmup_epochs 1")
    p.add_argument("--warmup_epochs", type=float, default=None, help="override TrainConfig.warmup_epochs")
    p.add_argument("--print_freq", type=int, default=1000,
                   help="log the train loss every N steps of an epoch (job_dir/run/train.jsonl)")
    p.add_argument("--job_dir", default=None)
    p.add_argument("--resume", action="store_true", help="export the run trained in --job_dir")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the init, the data order and the synthetic set (TrainConfig.seed)")
    a = p.parse_args(argv)

    from alignq_tpu_torch.data.registry import get_data
    from alignq_tpu_torch.models.registry import build_model
    from alignq_tpu_torch.train.config import TrainConfig
    from alignq_tpu_torch.train.loop import fit

    if a.stage_int8:
        if a.model != "densenet40":
            p.error("--stage_int8 is a densenet40 deploy option")
        a.deploy_exact = True  # the int8-buffer graph requantizes the stem input
    if a.model not in PREACT:
        for flag, on in (("--stage_kernel", a.stage_kernel), ("--stream int8", a.stream == "int8"),
                         ("--pack_int4", a.pack_int4), ("--deploy_act_impl bins_int", a.deploy_act_impl == "bins_int")):
            if on:
                p.error(f"{flag} is a PreAct ResNet deploy option")
    if a.stream == "int8" and not a.deploy_exact:
        p.error("--stream int8 requires --deploy_exact")
    if a.pack_int4 and a.bits != 4:
        p.error("--pack_int4 requires --bits 4 (codes must fit a nibble)")
    try:
        int_kw = int_forward_kwargs(a.bits, a.cdf_impl, a.deploy_act_impl, a.stream, a.stage_kernel)
    except ValueError as e:
        p.error(str(e))
    if a.pack_int4 and int_kw["act_impl"] == "bins_int":
        p.error("bins_int + --pack_int4 is not supported (serving derives the cutpoints from unpacked weights)")
    target, exclude = FAMILIES[a.model]
    cfg = TrainConfig(
        target_model=target, method="ours", bitW=a.bits, abitW=a.bits, variant=a.variant, dataset=a.dataset,
        data_dir=a.data_dir, num_epochs=a.epochs, train_batch_size=a.batch, eval_batch_size=a.batch,
        print_freq=a.print_freq, seed=a.seed,
        correction_exclude=exclude, deploy_exact=a.deploy_exact, cdf_impl=a.cdf_impl,
        stream_int8=(a.stream == "int8"), stage_int8=a.stage_int8, stage_calib=a.stage_calib, admm=a.admm,
        mxu_bf16=a.mxu_bf16, **({"lr": a.lr} if a.lr is not None else {}),
        **({"warmup_epochs": a.warmup_epochs} if a.warmup_epochs is not None else {}),
        **({"job_dir": a.job_dir} if a.job_dir else {}),
    )
    data = get_data(cfg.dataset, cfg.data_dir, cfg.train_batch_size, cfg.eval_batch_size, cfg.seed)
    result = fit(cfg, data, resume=a.resume, device=a.device)
    model = result["state"].model
    if a.mxu_bf16:
        # the f32 twin of the bf16 train model, on the same weights
        f32 = build_model(dataclasses.replace(cfg, mxu_bf16=False)).to(next(model.parameters()).device)
        f32.load_state_dict(model.state_dict())
        model = f32
    meta = {"model": a.model, "act_bits": a.bits, "weight_bits": a.bits, "act_impl": int_kw["act_impl"],
            "stream": a.stream, "variant": a.variant, "deploy_exact": int(a.deploy_exact),
            "packed_int4": int(a.pack_int4), "stage_int8": int(a.stage_int8), "use_stage_kernel": int(a.stage_kernel)}
    if a.model == "densenet40":
        meta["depth"] = model.depth
    report, qparams = export_and_compare(model, data.loader_test, a.model, meta)
    print(f"QAT fake-quant eval top1: {report['fq_top1']:.2f}")
    print(f"INT8 top1: {report['int_top1']:.2f}  fake-quant top1: {report['fq_top1']:.2f}  "
          f"prediction agreement: {report['agreement']:.2f}%")
    print(f"deployment accuracy delta (fake-quant - int8): {report['delta']:+.2f} pts")
    if report["disagree_margins"]:
        print(f"logit margins (fake-quant, INT) of the {len(report['disagree_margins'])} images that disagree: "
              f"{report['disagree_margins']}; median fake-quant top-1 less top-2 margin {report['median_margin']:.4g}; "
              f"largest INT - fake-quant logit gap {report['max_logit_gap']:.4g} (median {report['median_logit_gap']:.4g})")
    if a.save:
        from alignq_tpu_torch.kernels.artifact import save_int8_artifact
        from alignq_tpu_torch.kernels.convert import pack_qparams_int4

        save_int8_artifact(a.save, pack_qparams_int4(qparams) if a.pack_int4 else qparams, meta=meta)
        print(f"saved INT artifact -> {a.save}" + (" (int4-packed kernels)" if a.pack_int4 else ""))
    return {**report, "state": result["state"], "model": model, "qparams": qparams, "meta": meta}


if __name__ == "__main__":
    main()
