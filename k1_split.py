#!/usr/bin/env python3
"""Where K1's time goes, on one CUDA card: its kernels against variants
of themselves built from edited copies of their sources.

    python3 k1_split.py

Each variant of csrc/qmatmul.cu (the mma.sync form), csrc/qmatmul_sm90.cu
(the Hopper form) and csrc/qmatmul_sm90n.cu (the narrow Hopper form) is
the source with one part taken out or changed, written with the headers
into alignq_tpu_torch/_kernels_build/split/<variant>/ (ignored by git) and
built with _build.NVCC_FLAGS, all at once:
- base: the source as it is;
- nostore: the act codes computed but not stored (each store behind a
  test that a run-time value makes false; the narrow form: every mode's
  output);
- wide (the mma.sync and Hopper forms): one lane in 16 columns stores the
  16 bytes of its row's codes in one 16-byte store, the others none (the
  bytes of the real store, from an eighth of the instructions; the values
  are not the codes);
- noepi: the low bytes of the accumulators stored without the act-code
  map (the narrow form: in the codes modes);
- noprod: no tensor-core product (the accumulators stay 0; the compiler
  may then fold some of the epilogue's map);
- noband (the narrow form): no band copies (the products read what the
  buffers hold).
Each variant's library replaces the loaded one (`_build._libs`), and its
launch at each shape of SHAPES is timed by utils/cuda_timing.py graph_ms
(cold L2) in the order base, variants, variants backwards, base, each
variant's two times averaged. The launches run on random operands; the
variants' outputs are not checked (only base computes the conv). Prints
one line a shape and variant, beside the card's name and power limit,
and one JSON line, also written to chiprun_out/k1_split.json.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

# (label, batch, H, W, C, ksize, stride, N): ResNet-20's stage-1 and block-3
# conv1 at the bench batch, DenseNet-40's first and deepest growth convs and
# first transition at 256, ResNet-20's block-6 conv1 at 2048, each in the
# form the planner gives it
SHAPES = [
    ("resnet20 stage1 conv", 2048, 32, 32, 16, 3, 1, 16),
    ("resnet20 block3 conv1", 2048, 16, 16, 32, 3, 1, 32),
    ("densenet40 32x32x48->16", 256, 32, 32, 48, 3, 1, 16),
    ("densenet40 8x8x448->16", 256, 8, 8, 448, 3, 1, 16),
    ("densenet40 1x1 176->168", 256, 32, 32, 176, 1, 1, 168),
]
if len(sys.argv) > 1:  # python3 k1_split.py LABEL...: those shapes only
    SHAPES = [s_ for s_ in SHAPES if s_[0] in sys.argv[1:]]
MODES = ("poly", "f32")

STORE = ("static_cast<uint16_t*>(out)[at >> 1] = pack2(site_code<MODE>(a0, s0, c0, col, act, ld),\n"
         "                                                 site_code<MODE>(a1, s1, c1, col + 1, act, ld));")
CODES = "const uint16_t v_ = pack2(site_code<MODE>(a0, s0, c0, col, act, ld), site_code<MODE>(a1, s1, c1, col + 1, act, ld));"
HEADER_EDITS = {
    "nostore": [(STORE, "{ " + CODES + " if (v_ == act.g + 0x10000) static_cast<uint16_t*>(out)[at >> 1] = v_; }")],
    "wide": [(STORE, "{ " + CODES + " if ((col & 15) == 0) *reinterpret_cast<uint4*>(static_cast<unsigned char*>(out)"
                     " + (at & ~static_cast<size_t>(15))) = make_uint4(v_, v_, v_, v_); }")],
    "noepi": [(STORE, "static_cast<uint16_t*>(out)[at >> 1] = pack2(a0, a1);")],
}
NEVER = "if (p.N8 < 0) "  # a test that a run-time value makes false
# each source's variants, and the edits of its own text each takes
SOURCE_EDITS = {
    "qmatmul": {
        "base": [], "nostore": [], "wide": [], "noepi": [],
        "noprod": [("for (int mi = 0; mi < MT; ++mi) mma_s8(acc[mi][j], af[mi], b0, b1);",
                    "for (int mi = 0; mi < MT; ++mi) acc[mi][j][0] += static_cast<int>(b0 & b1 & 0);")],
    },
    "qmatmul_sm90": {
        "base": [], "nostore": [], "wide": [], "noepi": [],
        "noprod": [("wgmma_rs<NB>(acc, a, desc, chunk > 0 || k > 0);", ""), ("int acc[NB / 2];", "int acc[NB / 2] = {};")],
    },
    "qmatmul_sm90n": {
        "base": [],
        "noepi": [("static_cast<uint32_t>(site_code<MODE>(v[k + e], sc[c + k + e], sc[NB + c + k + e], col + k + e,\n"
                   "                                                           act, p.N8))",
                   "static_cast<uint32_t>(v[k + e])")],
        "nostore": [("          *reinterpret_cast<uint4*>(dst) =", "          " + NEVER + "*reinterpret_cast<uint4*>(dst) ="),
                    ("          *reinterpret_cast<uint2*>(dst) =", "          " + NEVER + "*reinterpret_cast<uint2*>(dst) ="),
                    ("          if (!half) *reinterpret_cast<uint2*>", "          if (!half && p.N8 < 0) *reinterpret_cast<uint2*>"),
                    ("          *reinterpret_cast<uint4*>(dst + k) =", "          " + NEVER + "*reinterpret_cast<uint4*>(dst + k) =")],
        "noprod": [("wgmma_ss<NB>(acc[mg], da + 64 * mg, db, started);", "reg_fence(acc[mg][0]);"),
                   ("  int acc[MG][NB / 2];", "  int acc[MG][NB / 2] = {};")],
        "noband": [("    cp_async16(band + q * p.GS + 16 * pix, src, in ? 16 : 0);",
                    "    " + NEVER + "cp_async16(band + q * p.GS + 16 * pix, src, in ? 16 : 0);")],
    },
}


def write_variant(name: str, variant: str, root: Path) -> Path:
    """The edited copies of csrc/<name>.cu and every header in root/<name>-<variant>/."""
    from alignq_tpu_torch.kernels import _build

    out = root / f"{name}-{variant}"
    out.mkdir(parents=True, exist_ok=True)

    def edited(text, edits, what):
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"k1_split: {variant}'s edit does not match {what}")
            text = text.replace(old, new)
        return text

    for h in _build.CSRC.glob("*.cuh"):
        text = h.read_text()
        if h.name == "k1_epilogue.cuh":
            text = edited(text, HEADER_EDITS.get(variant, []) if name != "qmatmul_sm90n" else [], h.name)
        (out / h.name).write_text(text)
    src = out / f"{name}.cu"
    src.write_text(edited((_build.CSRC / f"{name}.cu").read_text(), SOURCE_EDITS[name][variant], f"{name}.cu"))
    return src


def build_variants(names, root: Path) -> dict:
    """{(name, variant): loaded library}, every nvcc started at once."""
    from alignq_tpu_torch.kernels import _build

    procs = {}
    for name in names:
        for variant in SOURCE_EDITS[name]:
            src = write_variant(name, variant, root)
            lib = src.with_suffix(".so")
            procs[name, variant] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"k1_split: nvcc failed for {key}:\n{log}")
        if key[1] == "base":
            print(f"ptxas {key[0]}: " + " ".join(sorted({ln.strip() for ln in log.splitlines()
                                                         if "Used" in ln or "arning" in ln or "spill" in ln}))[:3000])
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def bind(name: str, lib: ctypes.CDLL):
    """lib in place of the loaded csrc/<name>.cu, its arguments typed as the
    wrapper types them."""
    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import qmatmul as K1

    saved = _build._libs.get(name)
    _build._libs[name] = lib
    {"qmatmul": K1._lib, "qmatmul_sm90": K1._sm90_lib, "qmatmul_sm90n": K1._narrow_lib}[name]()
    return saved


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_split: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.utils.cuda_timing import graph_ms
    from chip_smoke import card_line

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for label, b, h, w, c, ks, st, n in SHAPES:
        x = torch.randint(-127, 128, (b, h, w, c), generator=gen, device=dev, dtype=torch.int8)
        kern = torch.randint(-127, 128, (ks, ks, c, n), generator=gen, device=dev, dtype=torch.int8)
        scale = (torch.rand(n, generator=gen, device=dev) * 2 - 0.4) * 2 / ((ks * ks * c) ** 0.5 * 73.3 ** 2)
        op = K1.pack_conv_weights(kern, scale, torch.randn(n, generator=gen, device=dev) * 0.5)
        plan = K1.k1_plan(b, h, w, c, ks, st, ks // 2, *op.wt.shape)
        cases.append((label, x, op, plan))
    names = sorted({type(p).__name__ for _, _, _, p in cases})
    source = {"ConvPlan": "qmatmul", "Sm90Plan": "qmatmul_sm90", "NarrowPlan": "qmatmul_sm90n"}
    names = [source[n] for n in names]
    root = _build.BUILD_DIR / "split"
    shutil.rmtree(root, ignore_errors=True)
    libs = build_variants(names, root)
    rows = []
    for label, x, op, plan in cases:
        name = source[type(plan).__name__]
        variants = list(SOURCE_EDITS[name])
        for mode in MODES:
            act = K1.act_map(mode, 127, dev) if mode != "f32" else None
            out = torch.empty((plan.B * plan.Ho * plan.Wo, op.wt.shape[0]), device=dev,
                              dtype=torch.float32 if mode == "f32" else torch.int8)
            times = {v: [] for v in variants}
            for v in variants + variants[::-1]:
                if mode == "f32" and v in ("wide", "noepi") or mode == "f32" and v == "nostore" and name != "qmatmul_sm90n":
                    continue  # those edits touch the codes' store only
                saved = bind(name, libs[name, v])
                try:
                    times[v].append(graph_ms(lambda: K1._k1_launch(x, op, plan, out, mode, act)))
                finally:
                    _build._libs[name] = saved
            means = {v: statistics.mean(t) for v, t in times.items() if t}
            rows.append(dict(shape=label, form=name, mode=mode, ms=means, runs=times))
            print(f"k1 split {label} ({name}, {mode}): " + ", ".join(f"{v} {t:.4f}" for v, t in means.items())
                  + f" ms [{card}]", flush=True)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    result = {"k1_split": rows, "card": card}
    (out_dir / "k1_split.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
