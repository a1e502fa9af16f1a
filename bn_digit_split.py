#!/usr/bin/env python3
"""Where the time of the BN-act table pass's Hopper kernel and of the digit
kernel goes, on one CUDA card: csrc/bn_table_sm90.cu and csrc/digit_sm90.cu
against variants of themselves built from edited copies of their sources.

    python3 bn_digit_split.py

Each variant is a source with one part taken out or changed, written with
the headers into alignq_tpu_torch/_kernels_build/split/<variant>/ (ignored
by git) and built with _build.NVCC_FLAGS, all at once (stem_dw_split.py's
build_variants and abba). The table kernel's:
- base: the source as it is;
- nogather: no table lookup, the x words stored as the codes;
- noload: no x load, a constant word gathered;
- nostore: the codes gathered but stored only where they equal a word no
  quad of codes takes (so, never);
- notable: no copy of the table (the gathers read whatever the shared
  memory holds);
timed (graph_ms, cold L2) at every table site of a DenseNet-40 stage_int8
forward at BN_BATCHES (the Hopper kernel at each, whichever form the rule
gives it), summed by dense block; and the base at 8 and 16 work items a
warp beside bn_table_kernel. The digit kernel's:
- base;
- nomap: the pooled sums' low bits stored as the codes, no map;
- noprod: no tensor-core product (the sums take A's words or the
  descriptor);
timed at each conv of a digit forward at DIGIT_BATCHES, and the prep pass
alone. Each variant's library replaces the loaded one (`_build._libs`),
in the order base, variants, variants backwards, base, each variant's two
times averaged. Only base's outputs are the kernels'. Prints one line a
shape and variant, beside the card's name and power limit, and one JSON
line, also written to chiprun_out/bn_digit_split.json.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

BN_BATCHES = (256, 8)
DIGIT_BATCHES = (256, 2048)

BN_EDITS = {
    "base": {},
    "nogather": {"bn_table_sm90.cu": [(
        "      for (int i = 0; i < U; ++i) v[i] = gather4(v[i], tab + 4 * l[i].pos, p.P);",
        "      for (int i = 0; i < U; ++i) v[i] = v[i];")]},
    "noload": {"bn_table_sm90.cu": [(
        "                   ? __ldg(reinterpret_cast<const unsigned int*>(xt + static_cast<size_t>(l[i].r) * p.ld + "
        "4 * l[i].q))",
        "                   ? 0x04030201u")]},
    "nostore": {"bn_table_sm90.cu": [(
        "        if (l[i].on) *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m0 + l[i].r) * p.c_out + 4 * "
        "l[i].q) = v[i];",
        "        if (l[i].on && v[i] == 0xffffffffu) *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m0 + "
        "l[i].r) * p.c_out + 4 * l[i].q) = v[i];")]},
    "notable": {"bn_table_sm90.cu": [(
        "    mbar_arrive_expect_tx(tab_bar, 256u * p.P);\n    bulk_load(tab, tab_g, 256u * p.P, tab_bar);",
        "    mbar_arrive_expect_tx(tab_bar, 0u);")]},
}

DIGIT_EDITS = {
    "base": {},
    "nomap": {"digit_sm90.cu": [
        ("      code[h][v] = pooled_code<MODE>(pooled[h][v], sc[col], sc[32 + col], tab, table, bnd, g, win);",
         "      code[h][v] = pooled[h][v];\n      win = false;"),
        ("      code[jj][v] = pooled_code<MODE>(pooled[jj][v], sc[col], sc[48 + col], tab, table, bnd, g, win);",
         "      code[jj][v] = pooled[jj][v];\n      win = false;")]},
    "noprod": {"digit_sm90.cu": [
        ("  for (int s = 0; s < C1_STEPS; ++s) wgmma_rs<32>(acc, a[s], desc_w + ((s * C1_STEP) >> 4), s);",
         "  for (int i = 0; i < 16; ++i) acc[i] = static_cast<int>(a[i & 3][i >> 2]);"),
        ("    wgmma_ss<48>(acc, desc_a + ((((j / 5) * 12 + j % 5) * 16) >> 4), desc_w + ((j * C2_STEP) >> 4), j);",
         "    acc[j % 24] += static_cast<int>(desc_a >> (j & 7));")]},
}


def main() -> int:
    import torch

    import chip_smoke
    from stem_dw_split import abba, build_variants

    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import digit as DSm
    from alignq_tpu_torch.kernels import infer_densenet as D
    from alignq_tpu_torch.kernels import infer_digit as DG
    from alignq_tpu_torch.kernels import quantize as K2
    from alignq_tpu_torch.kernels import stem as ST
    from alignq_tpu_torch.kernels.infer_digit import convert_mnist_dann
    from alignq_tpu_torch.interop import init_mnist_dann_params
    from alignq_tpu_torch.utils.cuda_timing import graph_ms

    if not torch.cuda.is_available():
        print("bn_digit_split: CUDA is not available", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    _build.build_all()
    bn_libs = build_variants("bn_table_sm90", BN_EDITS)
    dg_libs = build_variants("digit_sm90", DIGIT_EDITS)
    dev = torch.device("cuda")
    sms = K2._sms(torch.cuda.current_device())
    rows = []
    for batch in BN_BATCHES:
        _, (qp, x) = D.build_densenet40_int8(batch, device=dev, stage_int8=True)
        ops = D.pack_densenet40_operands(qp, stage_int8=True)
        with torch.inference_mode():
            rec = chip_smoke.record_launches(lambda: D.densenet40_int8_forward(qp, x, operands=ops, stage_int8=True))
        launches = []
        for kind, args in rec:
            if kind == "bn_table":  # the Hopper kernel at every site, whichever form the rule gives it
                xx, c_live, table, _, _, c_out = args
                plan = K2.bn_table_plan(xx.numel() // xx.shape[-1], xx.shape[-1], c_live, c_out, sms)
                launches.append((xx, c_live, table, plan, torch.empty((*xx.shape[:-1], c_out), dtype=torch.int8,
                                                                      device=dev)))
        blocks = {}
        for xx, c_live, table, plan, o in launches:
            blocks.setdefault(xx.shape[-1], []).append((xx, c_live, table, plan, o))
        for ld, ls in blocks.items():
            def block_sum(ls=ls):
                return sum(graph_ms(lambda: K2._bn_table_launch(xx, c_live, table, o, plan))
                           for xx, c_live, table, plan, o in ls)

            times = abba(bn_libs, "bn_table_sm90", block_sum)
            for name, t in times.items():
                ms = sum(t) / len(t)
                rows.append({"shape": f"densenet40 b{batch} pitch {ld} x{len(ls)}", "variant": name, "ms": ms,
                             "runs": t})
                print(f"table split, batch {batch}, the {len(ls)} launches at pitch {ld}, {name}: {ms:.4f} ms "
                      f"({', '.join(f'{v:.4f}' for v in t)}) [{card}]", flush=True)
            for label, u in [("bn_table_kernel", None), *((f"items {u}", u) for u in K2.BN_TABLE_ITEMS)]:
                forms = [(xx, c_live, table, o, None if u is None else K2.bn_table_plan(
                    xx.numel() // xx.shape[-1], xx.shape[-1], c_live, o.shape[-1], sms, items=u))
                    for xx, c_live, table, plan, o in ls]
                for xx, c_live, table, o, p_ in forms:  # each layout made before any graph is captured
                    K2._bn_table_launch(xx, c_live, table, o, p_)
                ms = sum(graph_ms(lambda: K2._bn_table_launch(xx, c_live, table, o, p_)) for xx, c_live, table, o, p_
                         in forms)
                rows.append({"shape": f"densenet40 b{batch} pitch {ld} x{len(ls)}", "variant": label, "ms": ms})
                print(f"table split, batch {batch}, the {len(ls)} launches at pitch {ld}, {label}: {ms:.4f} ms "
                      f"[{card}]", flush=True)
        del qp, x, ops, rec, launches, blocks
    _build._libs.pop("bn_table_sm90", None)
    params, stats = init_mnist_dann_params(torch.Generator().manual_seed(chip_smoke.SEED), "cpu")
    qp = chip_smoke.to_device(convert_mnist_dann(params, stats), dev)
    dops = DG.pack_mnist_dann_operands(qp)
    for batch in DIGIT_BATCHES:
        x = torch.rand((batch, 28, 28, 3), generator=torch.Generator().manual_seed(batch)).to(dev) * 2 - 1
        with torch.inference_mode():
            rec = chip_smoke.record_launches(lambda: DG.mnist_dann_int8_forward(qp, x, operands=dops))
        for _, (xin, op, plan, act) in rec:
            xk = DSm.digit_prep(xin) if plan.conv == 1 else xin
            c = DSm.CONVS[plan.conv]
            o = torch.empty((batch, c.pooled, c.pooled, c.n), dtype=torch.int8, device=dev)
            times = abba(dg_libs, "digit_sm90",
                         lambda: graph_ms(lambda: DSm._digit_launch(xk, op, act, plan, o)))
            for name, t in times.items():
                ms = sum(t) / len(t)
                rows.append({"shape": f"digit conv{plan.conv} b{batch}", "variant": name, "ms": ms, "runs": t})
                print(f"digit split conv{plan.conv} batch {batch}, {name}: {ms:.4f} ms "
                      f"({', '.join(f'{v:.4f}' for v in t)}) [{card}]", flush=True)
            if plan.conv == 1:
                prep_ms = graph_ms(lambda: ST._prep_launch(xin, xk, DSm._INV_S_DIGIT))
                rows.append({"shape": f"digit conv1 b{batch}", "variant": "prep pass", "ms": prep_ms})
                print(f"digit split conv1 batch {batch}, the prep pass: {prep_ms:.4f} ms [{card}]", flush=True)
    _build._libs.pop("digit_sm90", None)
    res = {"card": card, "rows": rows}
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bn_digit_split.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
