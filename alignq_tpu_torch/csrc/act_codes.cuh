// The act-site code map of the INT8 serving graph, as __device__ functions
// shared by K1's codes epilogue (qmatmul.cu) and K3 (stage_kernel.cu):
// codes = clip(round(c(h) * g), +-g), the fused form of the TPU kernel
// alignq_tpu/kernels/quantize.py:57 cdf_quantize_int8 (K2) at every act
// site, with the poly, erf, bins and bins_int variants of
// alignq_tpu_torch/kernels/quantize.py act_codes / int_bin_codes.
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
