#!/usr/bin/env python3
"""Where the time of K2's Hopper form goes, on one CUDA card:
csrc/cdf_quant_sm90.cu against variants of itself built from edited copies
of its source.

    python3 k2_split.py

Each variant is the source with one part taken out, written with the
headers into alignq_tpu_torch/_kernels_build/split/ (ignored by git) and
built with _build.NVCC_FLAGS, all at once (stem_dw_split.build_variants):
- base: the source as it is;
- fold: a table of |x| (the upper half of K2's table, buckets 512-1023,
  which the map's oddness makes the relu'd map's) and x's sign put back;
- contig: a thread's 16 elements consecutive, one 16-byte store of their
  codes;
- nopipe: PIPE unset (a tile's loads issued after the tile before's codes);
- nowindows: no code tested for a table window (exact only where the
  table has none, as on the H100);
- l2hint: each load with an L2 prefetch of 256 bytes (ld.global.cs.L2::256B);
- stcs: the code stores as streaming stores (st.global.cs);
- nolookup: no table lookup (each code from the value's own bits by a few
  ALU operations, no shared-memory load): the kernel's streaming alone;
- notable: no copy of the table into shared memory (the lookups read what
  the shared memory holds);
- nostore: the codes computed but not stored;
- noload: no input loads (the codes of each element's index).
The outputs of base and of the variants up to stcs are the kernel's (each
is checked bit for bit against the direct kernel). Each variant's library
replaces the loaded one (the plan follows it: its CTAs an SM), and its
launches at the act-site sizes of batches 2048 and 256 are timed by
utils/cuda_timing.py graph_ms (cold L2) in the order base, variants,
variants backwards, base, each variant's two times averaged, beside the
direct kernel (csrc/quantize.cu) and the bound. Prints one line a size
and variant, beside the card's name and power limit, and one JSON line,
also written to chiprun_out/k2_split.json.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

STORE = "    for (int j = 0; j < 4; ++j) *reinterpret_cast<uint32_t*>(out + e0 + j * QSTEP) = w[j];"
LOAD = "  for (int j = 0; j < 4; ++j) v[j] = __ldcs(reinterpret_cast<const float4*>(x + e0 + j * QSTEP));"
EDITS = {
    "base": {},
    "fold": {"cdf_quant_sm90.cu": [
        ("constexpr int N_TAB = act::BUCKETS;", "constexpr int N_TAB = act::BUCKETS / 2;"),
        ("void k2_codes(const float (&x)[N], int (&code)[N], const int2* __restrict__ tab) {",
         "void k2_codes(const float (&xs)[N], int (&code)[N], const int2* __restrict__ tab) {\n"
         "  float x[N];\n#pragma unroll\n  for (int j = 0; j < N; ++j) x[j] = fabsf(xs[j]);"),
        ("e[j] = act::table_entry(x[j], tab, 0, N_TAB);", "e[j] = act::table_entry(x[j], tab, N_TAB, N_TAB);"),
        ("code[j] = x[j] == x[j] ? code[j] : 0;", "code[j] = xs[j] < 0.0f ? -code[j] : code[j];"),
        ("te[k] = table[threadIdx.x + k * THREADS];", "te[k] = table[N_TAB + threadIdx.x + k * THREADS];"),
        ("n_entries != N_TAB", "n_entries != 2 * N_TAB")]},
    "contig": {"cdf_quant_sm90.cu": [
        ("constexpr int QSTEP = 128;", "constexpr int QSTEP = 4;"),
        ("const long long off = 512 * warp + 4 * lane;",
         "const long long off = PER_THREAD * threadIdx.x;\n  (void)lane, (void)warp;"),
        ("#pragma unroll\n" + STORE,
         "    *reinterpret_cast<uint4*>(out + e0) = make_uint4(w[0], w[1], w[2], w[3]);")]},
    "nopipe": {"cdf_quant_sm90.cu": [("constexpr bool PIPE = true;", "constexpr bool PIPE = false;")]},
    "nowindows": {"cdf_quant_sm90.cu": [
        ("    in |= static_cast<unsigned>(act::in_window(x[j], e[j])) << j;\n", "")]},
    "l2hint": {"cdf_quant_sm90.cu": [(
        LOAD,
        "  for (int j = 0; j < 4; ++j)\n"
        "    asm(\"ld.global.cs.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];\"\n"
        "                 : \"=f\"(v[j].x), \"=f\"(v[j].y), \"=f\"(v[j].z), \"=f\"(v[j].w) : \"l\"(x + e0 + j * QSTEP));")]},
    "stcs": {"cdf_quant_sm90.cu": [(
        STORE,
        "    for (int j = 0; j < 4; ++j) __stcs(reinterpret_cast<unsigned int*>(out + e0 + j * QSTEP), w[j]);")]},
    "nolookup": {"cdf_quant_sm90.cu": [(
        "e[j] = act::table_entry(x[j], tab, 0, N_TAB);",
        "e[j] = make_int2(__float_as_int(x[j]) & 0xffff, 0);")]},
    "notable": {"cdf_quant_sm90.cu": [(
        "te[k] = table[threadIdx.x + k * THREADS];", "te[k] = make_int2(k, 0);")]},
    "nostore": {"cdf_quant_sm90.cu": [(
        STORE,
        "    for (int j = 0; j < 4; ++j)\n"
        "      if (w[j] == 0x12345678u && n < 0) *reinterpret_cast<uint32_t*>(out + e0 + j * QSTEP) = w[j];")]},
    "noload": {"cdf_quant_sm90.cu": [(
        LOAD,
        "  for (int j = 0; j < 4; ++j) {\n"
        "    const float f = static_cast<float>(e0 + j * QSTEP) * 1e-6f;\n"
        "    v[j] = make_float4(f, -f, f * 0.5f, f * 2.0f);\n"
        "  }")]},
}
EXACT = ("base", "fold", "contig", "nopipe", "nowindows", "l2hint", "stcs")  # the variants that compute the kernel's codes
BATCHES = (2048, 256)


def main() -> int:
    import torch

    import chip_smoke
    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import quantize as K2
    from alignq_tpu_torch.utils.cuda_timing import graph_ms
    from stem_dw_split import abba, build_variants

    if not torch.cuda.is_available():
        print("k2_split: CUDA is not available", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    libs = build_variants("cdf_quant_sm90", EDITS)
    variant_of = {str(lib): name for name, lib in libs.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    rows = []
    for batch in BATCHES:
        for name, n in chip_smoke.act_site_sizes(batch):
            x = torch.randn(n, generator=gen, device=dev) * 1.5
            out = torch.empty(n, dtype=torch.int8, device=dev)
            K2._k2_launch(x, out)
            want = out.clone()

            def variant_ms():
                """The loaded variant's launch, on its own plan; the exact
                variants' codes checked first."""
                lib = K2._k2_lib()
                plan = K2.k2_plan(n, K2._sms(dev.index or 0), lib.cdf_quant_sm90_per_sm())
                out.zero_()
                K2._k2_sm90_launch(x, out, plan)
                if variant_of[lib._name] in EXACT and not torch.equal(out, want):
                    raise AssertionError(f"the {variant_of[lib._name]} variant differs from the direct kernel at "
                                         f"{name} n={n}")
                return graph_ms(lambda: K2._k2_sm90_launch(x, out, plan))

            times = abba(libs, "cdf_quant_sm90", variant_ms)
            direct = graph_ms(lambda: K2._k2_launch(x, out))
            bound_ms = chip_smoke.bound(5 * n, chip_smoke.K2_TABLE_OPS_PER_ELEMENT * n,
                                        chip_smoke.PEAK_F32_OPS_PER_S)[0]
            for variant, t in times.items():
                ms = sum(t) / len(t)
                rows.append({"batch": batch, "shape": name, "n": n, "variant": variant, "ms": ms, "runs": t,
                             "direct_ms": direct, "bound_ms": bound_ms})
                print(f"k2 split batch {batch} {name} n={n} {variant}: {ms:.4f} ms ({', '.join(f'{v:.4f}' for v in t)};"
                      f" the direct kernel {direct:.4f}, bound {bound_ms:.4f}) [{card}]", flush=True)
            del x, out
    _build._libs.pop("cdf_quant_sm90", None)
    sums = {}
    for r in rows:
        s = sums.setdefault(f"batch {r['batch']} {r['variant']}", {"ms": 0.0, "direct_ms": 0.0, "bound_ms": 0.0})
        for k in s:
            s[k] += r[k]
    for k, v in sums.items():
        print(f"k2 split, the three act-site sizes of {k}: {v['ms']:.4f} ms (the direct kernel {v['direct_ms']:.4f}, "
              f"bound {v['bound_ms']:.4f}) [{card}]", flush=True)
    res = {"card": card, "rows": rows, "sums": sums}
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "k2_split.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
