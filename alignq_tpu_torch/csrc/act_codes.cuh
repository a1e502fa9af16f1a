// The act-site code map of the INT8 serving graph, as __device__ functions
// shared by K1's codes epilogue (qmatmul.cu), K3 (stage_kernel.cu) and the
// stem kernel (stem_sm90.cu, through the table form):
// codes = clip(round(c(h) * g), +-g), the fused form of the TPU kernel
// alignq_tpu/kernels/quantize.py:57 cdf_quantize_int8 (K2) at every act
// site, with the poly, erf, bins and bins_int variants of
// alignq_tpu_torch/kernels/quantize.py act_codes / int_bin_codes. And K2's
// own map, as_code (A&S 7.1.26), which quantize.cu's cdf_quant_kernel
// evaluates directly and cdf_quant_sm90.cu through its step table.
//
// Rounding rule, as the JAX graph under jit: every f32 `a * b + c` is one
// rounding (__fmaf_rn), a division by a constant is a multiply by its f32
// reciprocal, and every other step is an explicit _rn intrinsic so that
// nvcc can neither contract nor reorder it. rintf rounds half to even like
// jnp.round. Build with no fast-math flags.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace act {

__device__ __forceinline__ int round_clip(float c, float gf) {
  return static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(c, gf)), -gf), gf));
}

// ERF_SQRT2_POLY (alignq_tpu_torch/quant/cdf.py), each coefficient rounded
// once to f32; tests/test_torch_stage_kernel.py checks these literals.
// RN: rint(c * g) by one rounding conversion (F2I.RN), left for the caller
// to clip (stage_kernel_sm90.cu clips in integers, relu included): g is
// whole, so clipping before or after the conversion gives the same code.
template <bool RN = false>
__device__ __forceinline__ int poly_code(float h, float gf) {
  const float zc = fminf(fmaxf(h, -3.0f), 3.0f);
  const float u = __fmul_rn(zc, zc);
  float acc = -0x1.8d9d24p-27f;
  acc = __fmaf_rn(acc, u, 0x1.39f95ap-21f);
  acc = __fmaf_rn(acc, u, -0x1.d0cc62p-17f);
  acc = __fmaf_rn(acc, u, 0x1.b7fe68p-13f);
  acc = __fmaf_rn(acc, u, -0x1.3067b0p-9f);
  acc = __fmaf_rn(acc, u, 0x1.45a8c8p-6f);
  acc = __fmaf_rn(acc, u, -0x1.10417ep-3f);
  acc = __fmaf_rn(acc, u, 0x1.98834cp-1f);
  if constexpr (RN) return __float2int_rn(__fmul_rn(__fmul_rn(zc, acc), gf));
  return round_clip(__fmul_rn(zc, acc), gf);
}

// erf_sqrt2(h, 'erf') of quant/cdf.py: XLA's f32 erf of h * (1/sqrt2),
// x * P(x^2) / Q(x^2) on x clamped to +-3.7439211, Horner steps rounded
// once; the constants are quant/cdf.py's _ERF_CLAMP, _ERF_P and _ERF_Q
// rounded to f32 (checked by tests/test_torch_quantize.py).
__device__ __forceinline__ int erf_code(float h, float gf) {
  const float x = __fmul_rn(h, 0x1.6a09e6p-1f);
  const float xc = fminf(fmaxf(x, -0x1.df38cep+1f), 0x1.df38cep+1f);
  const float x2 = __fmul_rn(xc, xc);
  float p = 0x1.e05aa2p-13f;
  p = __fmaf_rn(p, x2, 0x1.bebb44p-9f);
  p = __fmaf_rn(p, x2, 0x1.a16dd6p-5f);
  p = __fmaf_rn(p, x2, 0x1.7b4e80p-3f);
  p = __fmaf_rn(p, x2, 0x1.20dd74p+0f);
  float q = -0x1.fa720cp-24f;
  q = __fmaf_rn(q, x2, 0x1.8b11bep-16f);
  q = __fmaf_rn(q, x2, 0x1.0ada50p-10f);
  q = __fmaf_rn(q, x2, 0x1.cd0fa8p-7f);
  q = __fmaf_rn(q, x2, 0x1.c69842p-4f);
  q = __fmaf_rn(q, x2, 0x1.fd6894p-2f);
  q = __fmaf_rn(q, x2, 0x1.000000p+0f);
  return round_clip(__fdiv_rn(__fmul_rn(xc, p), q), gf);
}

// K2's map (IMPL AS, no K1 epilogue mode): clip(round(erf(x / sqrt2) *
// 127), +-127), erf by Abramowitz-Stegun 7.1.26 as the TPU kernel
// alignq_tpu/kernels/quantize.py _cdf_quant_kernel computes it under jit
// (kernels/quantize.py cdf_quantize_int8_plain repeats it): the multiply by
// the f32 reciprocal of sqrt2, 1 / (1 + p|z|) as an IEEE division of a
// rounded-once multiply-add, the Horner steps rounded once, the full
// precision expf (not __expf), 1 - poly * e as fma(-poly, e, 1), then the
// sign, rintf (half to even, as jnp.round) and the clip. The sign is put
// on after |z|, so the map is odd (code(-x) = -code(x)), and NaN gives 0.
// The A&S constants rounded to f32 (kernels/quantize.py _AS_P, _AS_A;
// checked by tests/test_torch_quantize.py).
constexpr int AS = 8;
__device__ __forceinline__ int as_code(float x) {
  const float z = __fmul_rn(x, 0x1.6a09e6p-1f);
  const float az = fabsf(z);
  const float t = __fdiv_rn(1.0f, __fmaf_rn(0x1.4f740ap-2f, az, 1.0f));
  float poly = 0x1.0fb844p+0f;
  poly = __fmaf_rn(poly, t, -0x1.7401c6p+0f);
  poly = __fmaf_rn(poly, t, 0x1.6be1c6p+0f);
  poly = __fmaf_rn(poly, t, -0x1.23531cp-2f);
  poly = __fmaf_rn(poly, t, 0x1.04f20cp-2f);
  poly = __fmul_rn(poly, t);
  const float e = expf(__fmul_rn(-az, az));
  const float y = __fmaf_rn(-poly, e, 1.0f);
  const float c = z > 0.0f ? y : (z < 0.0f ? -y : 0.0f);  // jnp.sign(z) * y
  return round_clip(c, 127.0f);
}

// The direct map of a table form (IMPL: 4 erf, 3 poly, AS; K2's ignores g)
template <int IMPL>
__device__ __forceinline__ int direct_code(float h, float gf) {
  if constexpr (IMPL == 4) return erf_code(h, gf);
  else if constexpr (IMPL == AS) return as_code(h);
  else return poly_code(h, gf);
}

// Compares against the g (<= 15) f32 erf-grid boundaries t_k of
// erf_grid_boundaries(g): code(h) >= k iff h >= t_k, <= -k iff h <= -t_k.
__device__ __forceinline__ int bins_code(float h, const float* __restrict__ bnd, int g) {
  int code = 0;
  for (int k = 0; k < g; ++k) {
    const float tk = bnd[k];
    code += (h >= tk) - (h <= -tk);
  }
  return code;
}

// The erf, poly or K2 code (IMPL: 4 erf, 3 poly, k1_epilogue.cuh's mode
// codes; AS) of h, relu'd or not, through the map's step table
// (kernels/quantize.py act_table, ActTable): below lo the least code (0
// relu'd, else -g), above hi g; in [lo, hi] entry i = {base + g | w << 16,
// t} of h's bucket b_lo + i, the bucket floor(h * 128 + 512) by one
// rounding, gives base + (h >= t), except within w - 1 ulps above t
// (counted on t's side of 0), the window where the f32 map is not monotone
// (a few ulps at some steps, so the branch is rarely taken): there the
// map's own code. Equal to erf_code / poly_code / as_code (relu'd) for
// every f32 (chip_smoke.py checks all 2^32 patterns on the card). An entry
// load and a handful of ALU operations.
struct Table {
  const int2* tab;  // (n,) entries
  float lo, hi;
  int b_lo, n;
};
constexpr int BUCKETS = 1024;  // of h in [-4, 4): kernels/quantize.py ACT_TABLE_BUCKETS
constexpr int TABLE_MAX = BUCKETS;  // entries a table holds at most

// The map's own code, for h in a window: out of line, so that the rarely
// taken branch costs the lookup's code nothing (registers, scheduling)
template <int IMPL, bool RELU>
__device__ __noinline__ int window_code(float h, int g) {
  const int d = direct_code<IMPL>(h, static_cast<float>(g));
  return RELU ? max(d, 0) : d;
}

// h's entry of the table (tab, b_lo, n): its bucket, clamped to the
// table's (h outside [lo, hi], or NaN, takes an end entry whose code the
// callers' selects override; no window reaches past [lo, hi]); the clamped
// value is a whole number >= 0, so its truncation is its floor
__device__ __forceinline__ int2 table_entry(float h, const int2* __restrict__ tab, int b_lo, int n) {
  const float u = fminf(fmaxf(__fmaf_rn(h, 128.0f, 512.0f), static_cast<float>(b_lo)),
                        static_cast<float>(b_lo + n - 1));
  return tab[static_cast<int>(u) - b_lo];
}

// Whether h lies in entry e's window: within w - 1 ulps above its t
__device__ __forceinline__ bool in_window(float h, int2 e) {
  const int d = __int_as_float(e.y) >= 0.f ? __float_as_int(h) - e.y : e.y - __float_as_int(h);
  return static_cast<unsigned>(d) < static_cast<unsigned>(e.x >> 16);
}

// The code of h by its entry e, the window aside
template <bool RELU>
__device__ __forceinline__ int table_step_code(float h, int2 e, float lo, float hi, int g) {
  const int code = (e.x & 0xffff) - g + (h >= __int_as_float(e.y));
  return h > hi ? g : (h < lo ? (RELU ? 0 : -g) : code);
}

// K2's map gives NaN the code 0 (as_code's sign select), which the
// table's clamped bucket does not: selected here
template <int IMPL>
__device__ __forceinline__ int nan_code(float h, int code) {
  if constexpr (IMPL == AS) return h == h ? code : 0;
  else return code;
}

template <int IMPL, bool RELU>
__device__ __forceinline__ int table_code(float h, const int2* __restrict__ tab, float lo, float hi, int b_lo, int n,
                                          int g) {
  const int2 e = table_entry(h, tab, b_lo, n);
  return in_window(h, e) ? window_code<IMPL, RELU>(h, g) : nan_code<IMPL>(h, table_step_code<RELU>(h, e, lo, hi, g));
}

// table_code of four values at once: the four lookups first, then one
// rarely taken branch for those in a window (so that the lookups' loads
// are in flight together)
template <int IMPL, bool RELU>
__device__ __forceinline__ void table_code4(const float (&h)[4], int (&code)[4], const int2* __restrict__ tab,
                                           float lo, float hi, int b_lo, int n, int g) {
  int2 e[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = table_entry(h[j], tab, b_lo, n);
  unsigned in = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    code[j] = nan_code<IMPL>(h[j], table_step_code<RELU>(h[j], e[j], lo, hi, g));
    in |= static_cast<unsigned>(in_window(h[j], e[j])) << j;
  }
  if (in)
    for (int j = 0; j < 4; ++j)
      if ((in >> j) & 1) code[j] = window_code<IMPL, RELU>(h[j], g);
}

// Straight from the int32 accumulator of column `col`: a = acc * sgn, then
// sum_k (a >= t1[k]) - (a <= t2[k]); t1, t2 are (g, ld) row-major.
__device__ __forceinline__ int bins_int_code(int acc, int col, const int* __restrict__ sgn,
                                             const int* __restrict__ t1,
                                             const int* __restrict__ t2, int g, int ld) {
  const int a = acc * sgn[col];
  int code = 0;
  for (int k = 0; k < g; ++k) code += (a >= t1[k * ld + col]) - (a <= t2[k * ld + col]);
  return code;
}

}  // namespace act
