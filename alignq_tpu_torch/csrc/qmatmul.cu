// K1: int8 x int8 -> int32 GEMM with a fused dequant epilogue, for sm_90a.
//
// Replaces the TPU kernel alignq_tpu/kernels/qmatmul.py:45
// int8_matmul_dequant (body _qmm_kernel): y = relu?((x @ w) * scale + bias).
// The port also runs every int8 conv outside the stage kernel through it
// (the caller gathers the taps into x), so its shapes are tall and thin:
// M up to ~2M rows, K 16..576, N 16..128.
//
// What bounds it on an H100: bytes. At those shapes the f32 (M, N) output
// and the int8 (M, K) input dominate, and the arithmetic intensity is far
// below the ~600 int8 ops/byte where the tensor cores would be the limit.
// The design therefore keeps the tensor-core product simple (mma.sync
// m16n8k32, one 128-row tile by up to 128 columns per CTA, K walked in
// 32-byte steps through shared memory) and spends its care on moving each
// byte once: 16-byte loads of x rows, the whole N of a row tile in one CTA
// so x is read once, and the epilogue applied in registers straight from
// the accumulators, stored as 8-byte pairs that fill whole 32-byte sectors.
//
// Epilogue rule: f32 `acc * scale + bias` is ONE rounding (__fmaf_rn), the
// same as the JAX graph's contracted multiply-add under jit.
//
// Epilogue modes: the raw int32 accumulator; f32 `acc * scale + bias`
// (with or without relu); or the act-site codes of the serving graph, the
// fused form of K2 (alignq_tpu/kernels/quantize.py:57 cdf_quantize_int8):
// int8 clip(round(c(h) * g), +-g) of h = acc * scale + bias with c the
// poly, erf or boundary-bin map, or bins_int's integer compare chains
// straight on the accumulator (act_codes.cuh). In a codes mode the f32
// (M, N) tensor never reaches device memory: the output is int8, a quarter
// of the f32 bytes, stored as 2 codes a fragment row.
//
// C interface: qmm_launch returns cudaGetLastError() after the launch.
// Requirements (checked by the Python wrapper): x (M, Kp) and wt (N, Kp)
// int8 row-major with Kp % 32 == 0 and N % 8 == 0, both 16-byte aligned;
// for bins, bnd holds g f32 boundaries; for bins_int, sgn (N,) and t1, t2
// (g, N) int32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "act_codes.cuh"

namespace {

constexpr int BM = 128;     // rows per CTA: 8 warps x one 16-row MMA tile
constexpr int BK = 32;      // K per shared-memory step = one MMA depth
constexpr int NMAX = 128;   // columns per CTA: 16 n-tiles of 8
constexpr int SROW = 48;    // smem row stride in bytes: 32 + 16 of padding
                            // keeps the fragment loads free of bank conflicts
constexpr int THREADS = 256;

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Epilogue modes (the wrapper's kernels/qmatmul.py _MODE)
enum Mode { INT32 = 0, F32 = 1, RELU = 2, POLY = 3, ERF = 4, BINS = 5, BINS_INT = 6 };

struct ActArgs {
  const float* bnd;  // BINS: the g f32 erf-grid boundaries
  const int* sgn;    // BINS_INT: (N,) sign of each column's scale
  const int* t1;     // BINS_INT: (g, N) cutpoints of code >= k
  const int* t2;     // BINS_INT: (g, N) cutpoints of code <= -k
  int g;             // the grid's largest code
};

// The act code of one accumulator in column col (codes modes only)
template <int MODE>
__device__ __forceinline__ int site_code(int acc, float s, float b, int col,
                                         const ActArgs& a, int N) {
  if (MODE == BINS_INT) return act::bins_int_code(acc, col, a.sgn, a.t1, a.t2, a.g, N);
  // int -> f32 rounds to nearest, as the JAX graph's astype does
  const float h = __fmaf_rn(static_cast<float>(acc), s, b);
  const float gf = static_cast<float>(a.g);
  if (MODE == POLY) return act::poly_code(h, gf);
  if (MODE == ERF) return act::erf_code(h, gf);
  return act::bins_code(h, a.bnd, a.g);
}

__device__ __forceinline__ uint16_t pack2(int c0, int c1) {
  return static_cast<uint16_t>((c0 & 0xff) | (c1 & 0xff) << 8);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
           const float* __restrict__ scale, const float* __restrict__ bias,
           void* __restrict__ out, int M, int N, int Kp, ActArgs act_args) {
  __shared__ __align__(16) int8_t As[BM * SROW];
  __shared__ __align__(16) int8_t Bs[NMAX * SROW];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // MMA fragment group / thread
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * NMAX;
  const int nc = min(NMAX, N - n0);  // columns of this CTA, a multiple of 8
  const int ntiles = nc >> 3;

  int acc[NMAX / 8][4];
#pragma unroll
  for (int j = 0; j < NMAX / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  for (int k0 = 0; k0 < Kp; k0 += BK) {
    {  // x tile: 128 rows x 32 bytes, one 16-byte chunk per thread
      const int r = tid >> 1, half = tid & 1;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + r < M)
        v = *reinterpret_cast<const int4*>(x + (size_t)(m0 + r) * Kp + k0 + half * 16);
      *reinterpret_cast<int4*>(As + r * SROW + half * 16) = v;
    }
    for (int i = tid; i < 2 * nc; i += THREADS) {  // W^T tile: nc rows x 32 bytes
      const int r = i >> 1, half = i & 1;
      *reinterpret_cast<int4*>(Bs + r * SROW + half * 16) =
          *reinterpret_cast<const int4*>(wt + (size_t)(n0 + r) * Kp + k0 + half * 16);
    }
    __syncthreads();

    // A fragment (16 x 32, row-major): rows g and g+8, bytes 4t..4t+3 and
    // 16+4t..16+4t+3 of the step
    const int8_t* a = As + warp * 16 * SROW;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(a + g * SROW + t * 4);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(a + (g + 8) * SROW + t * 4);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(a + g * SROW + 16 + t * 4);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(a + (g + 8) * SROW + 16 + t * 4);
#pragma unroll
    for (int j = 0; j < NMAX / 8; ++j) {
      if (j < ntiles) {
        // B fragment (32 x 8, column-major): column g, the same k bytes
        const int8_t* b = Bs + (j * 8 + g) * SROW;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(b + t * 4);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(b + 16 + t * 4);
        mma_s8(acc[j], a0, a1, a2, a3, b0, b1);
      }
    }
    __syncthreads();
  }

  // C fragment: (row g, cols 2t, 2t+1) in acc[j][0..1], row g+8 in [2..3]
  const int r0 = m0 + warp * 16 + g;
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < NMAX / 8; ++j) {
    if (j < ntiles) {
      const int col = n0 + j * 8 + t * 2;
      if (MODE >= POLY) {
        const float s0 = scale[col], s1 = scale[col + 1];
        const float c0 = bias[col], c1 = bias[col + 1];
        uint16_t* o = static_cast<uint16_t*>(out);
        if (r0 < M)
          o[((size_t)r0 * N + col) >> 1] =
              pack2(site_code<MODE>(acc[j][0], s0, c0, col, act_args, N),
                    site_code<MODE>(acc[j][1], s1, c1, col + 1, act_args, N));
        if (r1 < M)
          o[((size_t)r1 * N + col) >> 1] =
              pack2(site_code<MODE>(acc[j][2], s0, c0, col, act_args, N),
                    site_code<MODE>(acc[j][3], s1, c1, col + 1, act_args, N));
      } else if (MODE == INT32) {
        int* o = static_cast<int*>(out);
        if (r0 < M) *reinterpret_cast<int2*>(o + (size_t)r0 * N + col) = make_int2(acc[j][0], acc[j][1]);
        if (r1 < M) *reinterpret_cast<int2*>(o + (size_t)r1 * N + col) = make_int2(acc[j][2], acc[j][3]);
      } else {
        float* o = static_cast<float*>(out);
        const float s0 = scale[col], s1 = scale[col + 1];
        const float c0 = bias[col], c1 = bias[col + 1];
        // int -> f32 rounds to nearest, as the JAX graph's astype does
        // (exact on the main path, where |acc| < 2^24)
        float y0 = __fmaf_rn((float)acc[j][0], s0, c0);
        float y1 = __fmaf_rn((float)acc[j][1], s1, c1);
        float y2 = __fmaf_rn((float)acc[j][2], s0, c0);
        float y3 = __fmaf_rn((float)acc[j][3], s1, c1);
        if (MODE == RELU) {
          y0 = fmaxf(y0, 0.f); y1 = fmaxf(y1, 0.f);
          y2 = fmaxf(y2, 0.f); y3 = fmaxf(y3, 0.f);
        }
        if (r0 < M) *reinterpret_cast<float2*>(o + (size_t)r0 * N + col) = make_float2(y0, y1);
        if (r1 < M) *reinterpret_cast<float2*>(o + (size_t)r1 * N + col) = make_float2(y2, y3);
      }
    }
  }
}

template <int MODE>
void launch(const void* x, const void* wt, const void* scale, const void* bias,
            void* out, int M, int N, int Kp, const ActArgs& a, cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + NMAX - 1) / NMAX);
  qmm_kernel<MODE><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<const float*>(scale), static_cast<const float*>(bias), out,
      M, N, Kp, a);
}

}  // namespace

extern "C" int qmm_launch(const void* x, const void* wt, const void* scale,
                          const void* bias, void* out, int M, int N, int Kp,
                          int mode, const void* bnd, const void* sgn,
                          const void* t1, const void* t2, int g, void* stream) {
  const ActArgs a{static_cast<const float*>(bnd), static_cast<const int*>(sgn),
                  static_cast<const int*>(t1), static_cast<const int*>(t2), g};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case INT32: launch<INT32>(x, wt, scale, bias, out, M, N, Kp, a, s); break;
    case F32: launch<F32>(x, wt, scale, bias, out, M, N, Kp, a, s); break;
    case RELU: launch<RELU>(x, wt, scale, bias, out, M, N, Kp, a, s); break;
    case POLY: launch<POLY>(x, wt, scale, bias, out, M, N, Kp, a, s); break;
    case ERF: launch<ERF>(x, wt, scale, bias, out, M, N, Kp, a, s); break;
    case BINS: launch<BINS>(x, wt, scale, bias, out, M, N, Kp, a, s); break;
    case BINS_INT: launch<BINS_INT>(x, wt, scale, bias, out, M, N, Kp, a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
