// K1's epilogue, shared by its forms (qmatmul.cu's mma.sync kernel, the
// wgmma kernels of qmatmul_sm90.cu, qmatmul_sm90n.cu, qmatmul_sm90p.cu and
// first_conv_sm90.cu), so that all map
// an int32 accumulator to the same f32 value or act code by the same
// instructions (site_code, word_value): on the card the forms agree bit for
// bit in every mode.
//
// Modes (kernels/qmatmul.py _MODE): the raw int32 accumulator; f32
// `acc * scale + bias`, ONE rounding (__fmaf_rn), with or without relu; the
// act-site codes of the serving graph (act_codes.cuh's poly, erf and bins
// maps of the f32 value, or bins_int's integer compare chains straight on
// the accumulator), relu'd or not; and the stage buffer's int8 requant
// clip(rint((acc * scale) * inv), +-127), inv in the bias vector.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "act_codes.cuh"

namespace k1 {

struct ActArgs {
  const float* bnd;  // BINS: the g f32 erf-grid boundaries
  const int* sgn;    // BINS_INT: (N8,) sign of each column's scale
  const int* t1;     // BINS_INT: (g, N8) cutpoints of code >= k
  const int* t2;     // BINS_INT: (g, N8) cutpoints of code <= -k
  int g;             // the grid's largest code
  int relu;          // codes modes: max(code, 0)
};

// Epilogue modes (the wrapper's kernels/qmatmul.py _MODE)
enum Mode { INT32 = 0, F32 = 1, RELU = 2, POLY = 3, ERF = 4, BINS = 5, BINS_INT = 6, REQUANT = 7 };

// The act code of one accumulator in column col (codes modes only)
template <int MODE>
__device__ __forceinline__ int site_code(int acc, float s, float b, int col,
                                         const ActArgs& a, int ld) {
  // int -> f32 rounds to nearest, as the JAX graph's astype does
  if (MODE == REQUANT)
    return static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(__fmul_rn(static_cast<float>(acc), s), b)), -127.f), 127.f));
  int code;
  if (MODE == BINS_INT) {
    code = act::bins_int_code(acc, col, a.sgn, a.t1, a.t2, a.g, ld);
  } else {
    const float h = __fmaf_rn(static_cast<float>(acc), s, b);
    const float gf = static_cast<float>(a.g);
    if (MODE == POLY) code = act::poly_code(h, gf);
    else if (MODE == ERF) code = act::erf_code(h, gf);
    else code = act::bins_code(h, a.bnd, a.g);
  }
  return a.relu ? max(code, 0) : code;
}

// The codes of four accumulators acc[j] of columns col[j] (scales s[j],
// biases b[j]; codes modes only): through the map's step table for POLY
// and ERF (act_codes.cuh table_code4: tab the entries in shared memory, t
// the table's bounds, built relu'd where a.relu is), else by site_code.
// Equal to site_code's in every mode, for every accumulator.
template <int MODE>
__device__ __forceinline__ void site_codes4(const int (&acc)[4], const float (&s)[4], const float (&b)[4],
                                            const int (&col)[4], const ActArgs& a, int ld, const int2* tab,
                                            const act::Table& t, int (&code)[4]) {
  if constexpr (MODE == POLY || MODE == ERF) {
    float h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __fmaf_rn(static_cast<float>(acc[j]), s[j], b[j]);
    if (a.relu) act::table_code4<MODE, true>(h, code, tab, t.lo, t.hi, t.b_lo, t.n, a.g);
    else act::table_code4<MODE, false>(h, code, tab, t.lo, t.hi, t.b_lo, t.n, a.g);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) code[j] = site_code<MODE>(acc[j], s[j], b[j], col[j], a, ld);
  }
}

__device__ __forceinline__ uint16_t pack2(int c0, int c1) {
  return static_cast<uint16_t>((c0 & 0xff) | (c1 & 0xff) << 8);
}

// The f32 epilogue value of one accumulator (modes F32 and RELU)
template <int MODE>
__device__ __forceinline__ float f32_value(int acc, float s, float b) {
  // int -> f32 rounds to nearest, as the JAX graph's astype does
  const float y = __fmaf_rn(static_cast<float>(acc), s, b);
  return MODE == RELU ? fmaxf(y, 0.f) : y;
}

// The 32-bit word of one element in the modes with 4-byte elements: the
// accumulator itself (INT32) or its f32 value's bits (F32, RELU)
template <int MODE>
__device__ __forceinline__ uint32_t word_value(int acc, float s, float b) {
  return MODE == INT32 ? static_cast<uint32_t>(acc) : __float_as_uint(f32_value<MODE>(acc, s, b));
}

// Row `row` of out (M, ld), columns col and col + 1, from the two
// accumulators a0 and a1 of those columns: s0, s1 and c0, c1 their scales
// and biases (unread in modes INT32 and BINS_INT)
template <int MODE>
__device__ __forceinline__ void store2(void* __restrict__ out, size_t row, int col, int ld, int a0, int a1,
                                       float s0, float s1, float c0, float c1, const ActArgs& act) {
  const size_t at = row * ld + col;
  if (MODE >= POLY) {
    static_cast<uint16_t*>(out)[at >> 1] = pack2(site_code<MODE>(a0, s0, c0, col, act, ld),
                                                 site_code<MODE>(a1, s1, c1, col + 1, act, ld));
  } else {
    *reinterpret_cast<uint2*>(static_cast<int*>(out) + at) =
        make_uint2(word_value<MODE>(a0, s0, c0), word_value<MODE>(a1, s1, c1));
  }
}

}  // namespace k1
