"""Train -> freeze -> INT8 export -> accuracy delta (port of
tools/export_int8.py for the PreAct ResNets).

Trains ResNet-20/56 with CDF QAT (`train/loop.py fit`), folds the trained
weights and BatchNorm statistics with `kernels/infer.py
convert_preact_resnet`, runs the INT graph (`resnet20_int8_forward`: on
the card K1's convs and, with --stage_kernel, K3) on the test set, and
reports fake-quant top-1, INT top-1, their delta and the two forwards'
prediction agreement.

    python -m alignq_tpu_torch.export_int8 --dataset synthetic --epochs 2 \\
        --deploy_exact --cdf_impl poly --stage_kernel

Runs on the CUDA card unless given --device cpu. --resume exports the run
already trained in --job_dir (its latest checkpoint) instead of training.
--save writes the frozen INT artifact that serve.engine_from_artifact
serves; with --bits 4, --pack_int4 packs its conv kernels two codes a byte.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Tuple

import numpy as np
import torch

from alignq_tpu_torch.interop import deploy_tree
from alignq_tpu_torch.kernels.infer import (
    augment_int_cutpoints,
    convert_preact_resnet,
    pack_int8_operands,
    resnet20_int8_forward,
)


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


def export_and_compare(model: torch.nn.Module, loader, bits: int, int_kw: dict) -> Tuple[Dict[str, float], Any]:
    """Fold the trained model into the INT graph and run both on every
    batch of loader, on the model's device. Returns ({'fq_top1',
    'int_top1', 'delta', 'agreement'} in percent, qparams)."""
    dev = next(model.parameters()).device
    qparams = convert_preact_resnet(*deploy_tree(model), weight_bits=bits, act_bits=bits)
    eval_qp = augment_int_cutpoints(qparams, bits) if int_kw["act_impl"] == "bins_int" else qparams
    ops = pack_int8_operands(eval_qp)
    correct = fq_correct = agree = total = 0
    with torch.no_grad():
        for xb, yb in loader:
            x = torch.from_numpy(np.ascontiguousarray(xb)).to(dev)
            pred_i8 = resnet20_int8_forward(eval_qp, x, operands=ops, **int_kw).argmax(-1).cpu().numpy()
            pred_fq = model(x, train=False).argmax(-1).cpu().numpy()
            y = np.asarray(yb)
            correct += int((pred_i8 == y).sum())
            fq_correct += int((pred_fq == y).sum())
            agree += int((pred_i8 == pred_fq).sum())
            total += len(y)
    out = {"fq_top1": 100 * fq_correct / total, "int_top1": 100 * correct / total,
           "delta": 100 * (fq_correct - correct) / total, "agreement": 100 * agree / total}
    return out, qparams


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="QAT -> INT8 export and its accuracy delta (PyTorch/CUDA)")
    p.add_argument("--model", default="resnet20", choices=["resnet20", "resnet56"])
    p.add_argument("--bits", type=int, default=8, choices=[8, 4], help="W/A bit width")
    p.add_argument("--variant", default="int8",
                   help="quantizer variant: 'int8' trains on the exact deployment grid; 'b' the reference grid")
    p.add_argument("--cdf_impl", choices=("erf", "poly"), default="erf",
                   help="act-site CDF in BOTH QAT and the INT graph")
    p.add_argument("--deploy_act_impl", choices=("same", "erf", "poly", "bins", "bins_int"), default="same",
                   help="act-site impl in the INT graph only (default: follow --cdf_impl)")
    p.add_argument("--deploy_exact", action="store_true",
                   help="deploy-exact QAT: the stem-input and residual requant sites in training")
    p.add_argument("--stream", choices=("int16", "int8"), default="int16",
                   help="residual-stream storage in the INT graph ('int8' needs --deploy_exact)")
    p.add_argument("--stage_kernel", action="store_true", help="runs of identity blocks through K3 (poly)")
    p.add_argument("--save", default=None, metavar="PATH.npz", help="save the frozen INT artifact")
    p.add_argument("--pack_int4", action="store_true",
                   help="with --save and --bits 4: nibble-pack the conv kernels (halves their bytes); "
                        "engine_from_artifact unpacks them once at load")
    p.add_argument("--admm", action="store_true", help="train with the ADMM correlation loss")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=None, help="override TrainConfig.lr")
    p.add_argument("--job_dir", default=None)
    p.add_argument("--resume", action="store_true", help="export the run trained in --job_dir")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)

    from alignq_tpu_torch.data.registry import get_data
    from alignq_tpu_torch.train.config import TrainConfig
    from alignq_tpu_torch.train.loop import fit

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
    cfg = TrainConfig(
        target_model=f"{a.model}_quant", method="ours", bitW=a.bits, abitW=a.bits, variant=a.variant,
        dataset=a.dataset, data_dir=a.data_dir, num_epochs=a.epochs, train_batch_size=a.batch,
        eval_batch_size=a.batch, print_freq=1000, correction_exclude=("conv0",), deploy_exact=a.deploy_exact,
        cdf_impl=a.cdf_impl, stream_int8=(a.stream == "int8"), admm=a.admm,
        **({"lr": a.lr} if a.lr is not None else {}), **({"job_dir": a.job_dir} if a.job_dir else {}),
    )
    data = get_data(cfg.dataset, cfg.data_dir, cfg.train_batch_size, cfg.eval_batch_size, cfg.seed)
    result = fit(cfg, data, resume=a.resume, device=a.device)
    model = result["state"].model
    report, qparams = export_and_compare(model, data.loader_test, a.bits, int_kw)
    print(f"QAT fake-quant eval top1: {report['fq_top1']:.2f}")
    print(f"INT8 top1: {report['int_top1']:.2f}  fake-quant top1: {report['fq_top1']:.2f}  "
          f"prediction agreement: {report['agreement']:.2f}%")
    print(f"deployment accuracy delta (fake-quant - int8): {report['delta']:+.2f} pts")
    if a.save:
        from alignq_tpu_torch.kernels.artifact import save_int8_artifact
        from alignq_tpu_torch.kernels.convert import pack_qparams_int4

        save_int8_artifact(a.save, pack_qparams_int4(qparams) if a.pack_int4 else qparams, meta={
            "model": a.model, "act_bits": a.bits, "weight_bits": a.bits, "act_impl": int_kw["act_impl"],
            "stream": a.stream, "variant": a.variant, "deploy_exact": int(a.deploy_exact),
            "packed_int4": int(a.pack_int4), "stage_int8": 0, "use_stage_kernel": int(a.stage_kernel),
        })
        print(f"saved INT artifact -> {a.save}" + (" (int4-packed kernels)" if a.pack_int4 else ""))
    return {**report, "state": result["state"], "qparams": qparams, "int_kwargs": int_kw}


if __name__ == "__main__":
    main()
