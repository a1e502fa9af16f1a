#!/usr/bin/env python3
"""Where the time of the stem kernel and of the depthwise form's Hopper
kernel goes, on one CUDA card: csrc/stem_sm90.cu and csrc/dwconv_sm90.cu
against variants of themselves built from edited copies of their sources.

    python3 stem_dw_split.py

Each variant is a source with one part taken out or changed, written with
the headers into alignq_tpu_torch/_kernels_build/split/<variant>/ (ignored
by git) and built with _build.NVCC_FLAGS, all at once. The stem's:
- base: the source as it is;
- direct: the erf or poly map evaluated directly (act_codes.cuh erf_code,
  poly_code) on each pooled output's h in place of its step table (not
  the stem's codes inside the map's windows);
- nowin: the table without its window test (not the map's codes);
- noepi: the pooled sum's low bits stored as the code, no map;
- noprod: no tensor-core product (the accumulators take A's registers);
- nopool: no pool and no output store;
and the base at each plan option of OPTIONS (pooled rows a tile,
warpgroups a CTA), and the prep pass alone. The depthwise kernel's:
- base, direct, nowin and noepi, as the stem's (per output, not per
  pooled one);
- notaps: no dp4a taps (the sums take the band's words);
- nostore: the codes computed but not stored;
- noband: only a CTA's first band copied (the later tiles read it again).
Each variant's library replaces the loaded one (`_build._libs`), and its
launches are timed by utils/cuda_timing.py graph_ms (cold L2) in the order
base, variants, variants backwards, base, each variant's two times
averaged: the stem at each shape of SHAPES, the depthwise kernel at every
depthwise launch of a MobileNet-V2 forward at DW_BATCHES, summed. Only
base's outputs are the kernels'. Prints one line a shape and variant,
beside the card's name and power limit, and one JSON line, also written
to chiprun_out/stem_dw_split.json.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

# (label, batch, image side, act map, grid): the trunks' stem at the
# serving batch and at the engines' batches
SHAPES = [("b256 erf", 256, 224, "erf", 127), ("b256 poly", 256, 224, "poly", 127), ("b4 erf", 4, 224, "erf", 127)]

EDITS = {  # the stem's variants
    "base": {},
    "direct": {"stem_sm90.cu": [(
        "    code[j] = act::table_step_code<true>(h[j], e[j], t.lo, t.hi, g);\n"
        "    in |= static_cast<unsigned>(act::in_window(h[j], e[j])) << j;",
        "    code[j] = max(MODE == ERF ? act::erf_code(h[j], static_cast<float>(g)) : act::poly_code(h[j], "
        "static_cast<float>(g)), 0);")]},
    "nowin": {"stem_sm90.cu": [(
        "  if (in)\n    for (int j = 0; j < 4; ++j)\n      if ((in >> j) & 1) code[j] = window_pool",
        "  if (false)\n    for (int j = 0; j < 4; ++j)\n      if ((in >> j) & 1) code[j] = window_pool")]},
    "noepi": {"stem_sm90.cu": [(
        "    code[j] = act::table_step_code<true>(h[j], e[j], t.lo, t.hi, g);\n"
        "    in |= static_cast<unsigned>(act::in_window(h[j], e[j])) << j;",
        "    code[j] = hi_[j] & 127;")]},
    "noprod": {"stem_sm90.cu": [(
        "for (int dy = 0; dy < KSTEPS; ++dy) wgmma_rs<NOUT>(acc, a[dy], desc_w + ((dy * W_STEP) >> 4), dy);",
        "for (int i = 0; i < NOUT / 2; ++i) acc[i] = static_cast<int>(a[i % KSTEPS][i & 3]);")]},
    "nopool": {"stem_sm90.cu": [(
        "for (int u = tid; u < p.R * p.Wp * (NOUT / 4); u += blockDim.x) {",
        "for (int u = tid; u < (p.B < 0 ? 1 : 0); u += blockDim.x) {")]},
}
# the base's plan options timed beside the variants: (pooled rows a tile, warpgroups a CTA)
OPTIONS = [(2, 4), (2, 2), (1, 4), (1, 2)]


DW_EDITS = {  # the depthwise kernel's variants
    "base": {},
    "direct": {"dwconv_sm90.cu": [(
        "      act::table_code4<MODE, RELU>(h, code, tab, t.lo, t.hi, t.b_lo, t.n, g);",
        "      for (int j = 0; j < 4; ++j) {\n        const int d_ = MODE == ERF ? "
        "act::erf_code(h[j], static_cast<float>(g)) : act::poly_code(h[j], static_cast<float>(g));\n"
        "        code[j] = RELU ? max(d_, 0) : d_;\n      }")]},
    "nowin": {"act_codes.cuh": [(
        "  if (in)\n    for (int j = 0; j < 4; ++j)\n      if ((in >> j) & 1) code[j] = window_code",
        "  if (false)\n    for (int j = 0; j < 4; ++j)\n      if ((in >> j) & 1) code[j] = window_code")]},
    "noepi": {"dwconv_sm90.cu": [(
        "      act::table_code4<MODE, RELU>(h, code, tab, t.lo, t.hi, t.b_lo, t.n, g);",
        "      for (int j = 0; j < 4; ++j) code[j] = acc[j] & 127;")]},
    "notaps": {"dwconv_sm90.cu": [(
        "    tap_sums(ca, cb, cc, qw, acc);",
        "    acc[0] = ca.v[0] ^ qw.v[0], acc[1] = cb.v[1], acc[2] = cc.v[2], acc[3] = ca.v[3];")]},
    "nostore": {"dwconv_sm90.cu": [(
        "    *reinterpret_cast<uint32_t*>(px) = word;",
        "    if (word == 0x12345678u && g < 0) *reinterpret_cast<uint32_t*>(px) = word;")]},
    "noband": {"dwconv_sm90.cu": [
        ("if (tid == 0 && next < p.n_tiles)", "if (tid == 0 && next < 0)"),
        ("    mbar_wait(bars + (n & 1), (n >> 1) & 1);", "    if (n == 0) mbar_wait(bars, 0);")]},
}
DW_BATCHES = (256, 8)


def build_variants(source: str, edits: dict) -> dict:
    """{variant: its library} of csrc/<source>.cu, built all at once."""
    from alignq_tpu_torch.kernels import _build

    dirs = []
    for name, variant in edits.items():  # every edited copy written before any build starts
        d = _build.BUILD_DIR / "split" / f"{source}_{name}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for src in _build.CSRC.iterdir():
            if src.suffix in (".cu", ".cuh"):
                text = src.read_text()
                for old, new in variant.get(src.name, []):
                    if old not in text:
                        raise SystemExit(f"{name}: {src.name} has no {old[:60]!r}")
                    text = text.replace(old, new)
                (d / src.name).write_text(text)
        dirs.append((name, d))
    procs = []
    for name, d in dirs:
        lib = d / f"lib{source}.so"
        procs.append((name, lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                                   str(d / f"{source}.cu")], stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, _, proc in procs:  # every build ends before any failure is raised
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for the {name} variant of {source}.cu:\n{log}")
    if failed:
        raise SystemExit("\n".join(failed))
    return {name: lib for name, lib, _ in procs}


def abba(libs: dict, key: str, fn) -> dict:
    """{variant: [ms, ms]}: fn() (one timing) with each variant's library
    loaded as csrc/<key>.cu's, in the order variants, variants backwards."""
    from alignq_tpu_torch.kernels import _build

    times = {}
    for name in list(libs) + list(libs)[::-1]:
        _build._libs[key] = ctypes.CDLL(str(libs[name]))
        times.setdefault(name, []).append(fn())
    _build._libs[key] = ctypes.CDLL(str(libs["base"]))
    return times


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels import stem as ST
    from alignq_tpu_torch.utils.cuda_timing import graph_ms

    if not torch.cuda.is_available():
        print("stem_dw_split: CUDA is not available", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    libs = build_variants("stem_sm90", EDITS)
    dw_libs = build_variants("dwconv_sm90", DW_EDITS)
    dev = torch.device("cuda")
    rows = []
    for label, b, hw, impl, g in SHAPES:
        rng = np.random.RandomState(0)
        x = torch.from_numpy((rng.randn(b, hw, hw, 3) * 1.2).astype(np.float32)).to(dev)
        k = torch.from_numpy(rng.randint(-127, 128, (7, 7, 3, 64)).astype(np.int8)).to(dev)
        s = torch.from_numpy((rng.uniform(1e-5, 4e-5, 64) * rng.choice([-1, 1], 64)).astype(np.float32)).to(dev)
        bias = torch.from_numpy(rng.uniform(-1, 1, 64).astype(np.float32)).to(dev)
        op = K1.pack_conv_weights(k, s, bias)
        act = K1.act_map(impl, g, dev, relu=True)
        plan = ST.stem_plan(b, hw, hw, 3, 64)
        xq = ST.stem_prep(x)
        out = torch.empty((b, plan.Hp, plan.Wp, 64), dtype=torch.int16, device=dev)
        times = abba(libs, "stem_sm90", lambda: graph_ms(lambda: ST._stem_launch(xq, op, act, plan, out)))
        for name, t in times.items():
            ms = sum(t) / len(t)
            rows.append({"shape": label, "variant": name, "ms": ms, "runs": t})
            print(f"stem split {label} {name}: {ms:.4f} ms ({', '.join(f'{v:.4f}' for v in t)}) [{card}]", flush=True)
        opt_t = {}
        for r, n_wg in OPTIONS + OPTIONS[::-1]:
            pl = ST.stem_plan(b, hw, hw, 3, 64, r=r, n_wg=n_wg)
            o = torch.empty((b, pl.Hp, pl.Wp, 64), dtype=torch.int16, device=dev)
            opt_t.setdefault((r, n_wg), []).append(graph_ms(lambda: ST._stem_launch(xq, op, act, pl, o)))
        for (r, n_wg), t in opt_t.items():
            ms = sum(t) / len(t)
            rows.append({"shape": label, "variant": f"base R={r} warpgroups={n_wg}", "ms": ms, "runs": t})
            print(f"stem split {label} base at R={r}, {n_wg} warpgroups: {ms:.4f} ms [{card}]", flush=True)
        prep_ms = graph_ms(lambda: ST._prep_launch(x, xq))
        rows.append({"shape": label, "variant": "prep pass", "ms": prep_ms})
        print(f"stem split {label} the prep pass: {prep_ms:.4f} ms [{card}]", flush=True)
        del x, xq, out
    _build._libs.pop("stem_sm90", None)
    from alignq_tpu_torch.kernels import dwconv as DWm
    from alignq_tpu_torch.kernels import infer_mobilenet as M

    for batch in DW_BATCHES:
        _, (qp, x) = M.build_mobilenetv2_int8(batch, device=dev)
        ops = M.pack_mobilenetv2_operands(qp)
        with torch.inference_mode():
            rec = chip_smoke.record_launches(lambda: M.mobilenetv2_int8_forward(qp, x, operands=ops))
        launches = []
        for kind, args in rec:
            if kind == "dw":
                xx, op, recorded, impl, act = args
                plan = DWm.dw_sm90_plan(*xx.shape, recorded.stride, DWm._sm_count(dev.index))
                o = torch.empty((xx.shape[0], plan.Ho, plan.Wo, xx.shape[3]), dtype=torch.int8, device=dev)
                launches.append((xx, op, plan, impl, act, o))

        def forward_sum():
            return sum(graph_ms(lambda: DWm._dw_launch(xx, op, plan, impl, act, o))
                       for xx, op, plan, impl, act, o in launches)

        times = abba(dw_libs, "dwconv_sm90", forward_sum)
        for name, t in times.items():
            ms = sum(t) / len(t)
            rows.append({"shape": f"mobilenetv2 depthwise x{len(launches)} b{batch}", "variant": name, "ms": ms,
                         "runs": t})
            print(f"depthwise split, a MobileNet-V2 forward's {len(launches)} launches at {batch}, {name}: {ms:.4f} ms "
                  f"({', '.join(f'{v:.4f}' for v in t)}) [{card}]", flush=True)
        del qp, x, ops, rec, launches
    _build._libs.pop("dwconv_sm90", None)
    res = {"card": card, "rows": rows}
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "stem_dw_split.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
