"""Forward throughput of every INT8 inference graph family on the card
(port of tools/model_zoo_bench.py; its rows and batches).

Each row is one served forward at full published width on random weights
from a seed, its operands laid out once (as an engine lays them out),
timed by CUDA events (utils/cuda_timing.py median_ms, the median of 20
after warm-up); on the CPU by the host clock (no device metric). Rows
(one JSON line each, {"name", "batch", "ms", "imgs_per_sec"}):

- resnet20_b{1024,2048,4096}: erf act sites, int16 stream; `_poly_b*` the
  poly grid; `_fast_b*` poly and the int8 stream (the bench's graph);
- resnet20_w4a4_*_b2048: W4A4 erf, `bins`, `bins_int`, `fast` (bins and
  the int8 stream), `bins_int_stream8`, and `packed`: the int4
  nibble-packed kernels unpacked in every forward
  (kernels/convert.py packed_int4_forward; an engine unpacks once, at
  load);
- resnet56_b1024 and resnet56_fast_b1024;
- densenet40_b1024, `_poly`, `_stage_int8`, `_stage_int8_poly`;
- mobilenetv2_b1024, `_poly`, `_w4a4_bins`;
- resnet50_b128 and resnet50_poly_b128 at 224x224 (the trunk's pooled
  feature).

DenseNet-40, MobileNet-V2 and ResNet-50 have no int8-stream knob, so their
fast row is the poly grid alone, as in the JAX tool.

    python -m alignq_tpu_torch.tools.model_zoo_bench [--families resnet20,densenet40] [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Iterator, Tuple

import torch

FAMILIES = ("resnet20", "resnet20_w4a4", "resnet56", "densenet40", "mobilenetv2", "resnet50")
BATCHES = {"resnet20": (1024, 2048, 4096), "resnet20_w4a4": (2048,), "resnet56": (1024,), "densenet40": (1024,),
           "mobilenetv2": (1024,), "resnet50": (128,)}
SMOKE_BATCHES = {"resnet50": (2,)}  # --smoke: batch 8 elsewhere
IMAGE = {"resnet50": 224}  # the input side where it is not CIFAR's 32


def _images(batch: int, side: int, dev, seed: int = 0) -> torch.Tensor:
    return torch.randn((batch, side, side, 3), generator=torch.Generator().manual_seed(seed)).to(dev)


def _preact(depth: int, dev, bits: int = 8):
    from alignq_tpu_torch.interop import init_preact_resnet_params
    from alignq_tpu_torch.kernels.infer import convert_preact_resnet

    params, stats = init_preact_resnet_params(depth, torch.Generator().manual_seed(1), dev)
    return convert_preact_resnet(params, stats, weight_bits=bits, act_bits=bits)


def forwards(family: str, batch: int, dev) -> Iterator[Tuple[str, Callable[[], torch.Tensor]]]:
    """(row name, a call of the row's forward on its images) for each row
    of `family` at `batch`; every operand laid out before the first."""
    from alignq_tpu_torch.kernels import infer as R

    x = _images(batch, IMAGE.get(family, 32), dev)
    if family in ("resnet20", "resnet56"):
        qp = _preact(20 if family == "resnet20" else 56, dev)
        ops = R.pack_int8_operands(qp)
        rows = (("", {}), ("_poly", {"act_impl": "poly"}), ("_fast", {"act_impl": "poly", "stream": "int8"}))
        if family == "resnet56":
            rows = (rows[0], rows[2])
        for suffix, kw in rows:
            yield f"{family}{suffix}_b{batch}", lambda kw=kw: R.resnet20_int8_forward(qp, x, operands=ops, **kw)
    elif family == "resnet20_w4a4":
        from alignq_tpu_torch.kernels.convert import pack_qparams_int4, packed_int4_forward

        qp = _preact(20, dev, bits=4)
        ops = R.pack_int8_operands(qp)
        qpi = R.augment_int_cutpoints(qp, 4)
        opsi = R.pack_int8_operands(qpi)
        packed = pack_qparams_int4(qp)
        for suffix, q, o, kw in (("", qp, ops, {}), ("_bins", qp, ops, {"act_impl": "bins"}),
                                 ("_bins_int", qpi, opsi, {"act_impl": "bins_int"}),
                                 ("_fast", qp, ops, {"act_impl": "bins", "stream": "int8"}),
                                 ("_bins_int_stream8", qpi, opsi, {"act_impl": "bins_int", "stream": "int8"})):
            yield (f"resnet20_w4a4{suffix}_b{batch}",
                   lambda q=q, o=o, kw=kw: R.resnet20_int8_forward(q, x, act_bits=4, operands=o, **kw))
        yield (f"resnet20_w4a4_packed_b{batch}",
               lambda: packed_int4_forward(R.resnet20_int8_forward, packed, x, act_bits=4, act_impl="bins",
                                           operands=ops))
    elif family == "densenet40":
        from alignq_tpu_torch.interop import init_densenet_params
        from alignq_tpu_torch.kernels import infer_densenet as D

        for stage_int8 in (False, True):
            params, stats = init_densenet_params(40, torch.Generator().manual_seed(1), dev, stage_int8=stage_int8)
            qp = D.convert_densenet40(params, stats, stage_int8=stage_int8)
            ops = D.pack_densenet40_operands(qp, stage_int8)
            tag = "_stage_int8" if stage_int8 else ""
            for suffix, kw in (("", {}), ("_poly", {"act_impl": "poly"})):
                yield (f"densenet40{tag}{suffix}_b{batch}",
                       lambda qp=qp, ops=ops, s=stage_int8, kw=kw: D.densenet40_int8_forward(
                           qp, x, stage_int8=s, operands=ops, **kw))
    elif family == "mobilenetv2":
        from alignq_tpu_torch.interop import init_mobilenetv2_params
        from alignq_tpu_torch.kernels import infer_mobilenet as M

        params, stats = init_mobilenetv2_params(torch.Generator().manual_seed(1), dev)
        for bits, rows in ((8, (("", {}), ("_poly", {"act_impl": "poly"}))),
                           (4, (("_w4a4_bins", {"act_impl": "bins"}),))):
            qp = M.convert_mobilenetv2(params, stats, weight_bits=bits, act_bits=bits)
            ops = M.pack_mobilenetv2_operands(qp)
            for suffix, kw in rows:
                yield (f"mobilenetv2{suffix}_b{batch}",
                       lambda qp=qp, ops=ops, bits=bits, kw=kw: M.mobilenetv2_int8_forward(
                           qp, x, act_bits=bits, operands=ops, **kw))
    elif family == "resnet50":
        from alignq_tpu_torch.interop import init_resnet_imagenet_params
        from alignq_tpu_torch.kernels import infer_resnet_imagenet as RI

        params, stats = init_resnet_imagenet_params("resnet50", torch.Generator().manual_seed(1), dev)
        qp = RI.convert_resnet_imagenet(params, stats)
        ops = RI.pack_resnet_imagenet_operands(qp)
        for suffix, kw in (("", {}), ("_poly", {"act_impl": "poly"})):
            yield (f"resnet50{suffix}_b{batch}",
                   lambda kw=kw: RI.resnet_imagenet_int8_forward(qp, x, operands=ops, **kw))
    else:
        raise ValueError(f"unknown family {family!r}; have {FAMILIES}")


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description="INT8 forward images/s of every graph family")
    p.add_argument("--families", default=",".join(FAMILIES))
    p.add_argument("--smoke", action="store_true", help="batch 8 (ResNet-50: 2), one timed forward")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)

    from alignq_tpu_torch.device import resolve_device
    from alignq_tpu_torch.utils.cuda_timing import time_forward_ms
    from alignq_tpu_torch.utils.launches import device_line

    dev = resolve_device(a.device)
    print(json.dumps({"card": device_line(dev)}), flush=True)
    runs, warmup = (1, 0) if a.smoke else (20, 3)
    rows = []
    for family in filter(None, (f.strip() for f in a.families.split(","))):
        batches = SMOKE_BATCHES.get(family, (8,)) if a.smoke else BATCHES[family]
        for batch in batches:
            for name, fwd in forwards(family, batch, dev):
                def call(fwd=fwd):
                    with torch.inference_mode():
                        return fwd()

                ms = time_forward_ms(call, dev, runs, warmup)
                rows.append({"name": name, "batch": batch, "ms": ms, "imgs_per_sec": batch / ms * 1e3})
                print(json.dumps(rows[-1]), flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    print(json.dumps({"summary": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
