// K2: CDF-alignment quantization of f32 to int8 codes, for sm_90a.
//
// Replaces the TPU kernel alignq_tpu/kernels/quantize.py:57
// cdf_quantize_int8 (body _cdf_quant_kernel, helper _erf_approx):
// q = clip(round(erf(x / sqrt2) * 127), +-127), erf by Abramowitz-Stegun
// 7.1.26, elementwise over f32 of any shape.
//
// What bounds it on an H100: bytes, 4 in and 1 out per element (about 60
// operations an element are far below the card's rate). The TPU kernel
// streamed a padded (rows, 1024) view through VMEM; here the wrapper hands
// over the flat tensor and each thread of a grid-stride loop loads 16 bytes
// of f32 (4 values) and stores their 4 codes as one 4-byte word, so every
// warp reads 512 and writes 128 contiguous bytes a step. The ragged tail
// (n % 4) is done by single-element steps after the loop; nothing is padded.
//
// Rounding rule, as the JAX kernel under jit (kernels/quantize.py
// cdf_quantize_int8_plain repeats it): the multiply by the f32 reciprocal
// of sqrt2, 1 / (1 + p|z|) as an IEEE division of a rounded-once
// multiply-add, the Horner steps rounded once (__fmaf_rn), the full
// precision expf (not __expf), 1 - poly * e as fma(-poly, e, 1), then the
// sign, rintf (half to even, as jnp.round) and the clip. Build with no
// fast-math flags.
//
// C interface: cdf_quant_launch returns cudaGetLastError() after the
// launch. Requirements (checked by the Python wrapper): x f32 and 16-byte
// aligned, out int8 with room for n codes.
//
// Beside K2, the fused BN-act code kernel of DenseNet's pre-activation
// sites (bn_act_launch). It replaces the elementwise pass that XLA fuses
// ahead of every DenseNet conv (alignq_tpu/kernels/infer_densenet.py
// _pre_act_conv, _stage_prealloc, _stage_prealloc_int8: bn -> act_q ->
// relu over the live-channel prefix of the stage buffer):
//     codes[m, c] = max(map(fma(x[m, c], s[c], b[c])), 0)   (c < c_live)
// x is the f32 stage buffer, or the int8 stage buffer's codes cast to f32
// (s then holds svec * bn.scale, folded once at load); map is
// act_codes.cuh's erf, poly or bins code, so one rounding per multiply-add
// and XLA's erf, as the JAX graph computes under jit. It reads the prefix
// in place, at the buffer's pixel pitch ld, and writes contiguous codes at
// a pitch c_out >= c_live, zero past c_live (K1's conv takes c_out
// channels, a multiple of 16).
//
// What bounds it: bytes. DenseNet re-reads the live prefix of its stage
// buffer before every conv; the pass does ~40 operations an element (erf)
// against 4 (f32) or 1 (int8) bytes in and 1 out. Each thread of a
// grid-stride loop takes 4 channels of a pixel (one 16- or 4-byte load,
// one 4-byte store), neighbouring threads on neighbouring quads.
//
// C interface: bn_act_launch returns cudaGetLastError() after the launch.
// Requirements (checked by kernels/quantize.py bn_act_codes): x 16-byte
// aligned, ld, c_live and c_out multiples of 4, c_live <= min(ld, c_out).

#include <cuda_runtime.h>
#include <stdint.h>

#include "act_codes.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CTAS = 132 * 16;  // 16 resident CTAs on each of 132 SMs

// A&S 7.1.26 constants rounded to f32 (kernels/quantize.py _AS_P, _AS_A;
// checked by tests/test_torch_quantize.py)
__device__ __forceinline__ int cdf_code(float x) {
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
  return static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(c, 127.0f)), -127.0f), 127.0f));
}

__global__ void __launch_bounds__(THREADS)
cdf_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long n4 = n >> 2;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  uint32_t* o4 = reinterpret_cast<uint32_t*>(out);
  for (long long i = first; i < n4; i += stride) {
    const float4 v = x4[i];
    o4[i] = (static_cast<uint32_t>(cdf_code(v.x)) & 0xff) |
            (static_cast<uint32_t>(cdf_code(v.y)) & 0xff) << 8 |
            (static_cast<uint32_t>(cdf_code(v.z)) & 0xff) << 16 |
            (static_cast<uint32_t>(cdf_code(v.w)) & 0xff) << 24;
  }
  for (long long i = (n4 << 2) + first; i < n; i += stride)
    out[i] = static_cast<int8_t>(cdf_code(x[i]));
}

// BN-act maps (the wrapper's kernels/quantize.py _BN_ACT_MODE)
enum BnActMode { POLY = 3, ERF = 4, BINS = 5 };

template <int MODE>
__device__ __forceinline__ int bn_act_code(float x, float s, float b, const float* bnd, int g, int relu) {
  const float h = __fmaf_rn(x, s, b);
  const float gf = static_cast<float>(g);
  int code;
  if (MODE == POLY) code = act::poly_code(h, gf);
  else if (MODE == ERF) code = act::erf_code(h, gf);
  else code = act::bins_code(h, bnd, g);
  return relu ? max(code, 0) : code;
}

__device__ __forceinline__ float4 load4(const float* x) { return *reinterpret_cast<const float4*>(x); }
__device__ __forceinline__ float4 load4(const int8_t* x) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(x);
  return make_float4(static_cast<float>(static_cast<int8_t>(v & 0xff)),
                     static_cast<float>(static_cast<int8_t>((v >> 8) & 0xff)),
                     static_cast<float>(static_cast<int8_t>((v >> 16) & 0xff)),
                     static_cast<float>(static_cast<int8_t>(v >> 24)));
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
bn_act_kernel(const T* __restrict__ x, const float* __restrict__ s, const float* __restrict__ b,
              uint32_t* __restrict__ out, long long m_rows, int ld, int c_live, int c_out,
              const float* __restrict__ bnd, int g, int relu) {
  const int quads = c_out / 4;
  const long long items = m_rows * quads;
  for (long long item = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; item < items;
       item += static_cast<long long>(gridDim.x) * THREADS) {
    const long long m = item / quads;
    const int c = 4 * static_cast<int>(item - m * quads);
    uint32_t word = 0;
    if (c < c_live) {
      const float4 v = load4(x + m * ld + c);
      word = (static_cast<uint32_t>(bn_act_code<MODE>(v.x, s[c], b[c], bnd, g, relu)) & 0xff) |
             (static_cast<uint32_t>(bn_act_code<MODE>(v.y, s[c + 1], b[c + 1], bnd, g, relu)) & 0xff) << 8 |
             (static_cast<uint32_t>(bn_act_code<MODE>(v.z, s[c + 2], b[c + 2], bnd, g, relu)) & 0xff) << 16 |
             (static_cast<uint32_t>(bn_act_code<MODE>(v.w, s[c + 3], b[c + 3], bnd, g, relu)) & 0xff) << 24;
    }
    out[item] = word;
  }
}

template <typename T, int MODE>
int bn_act_run(const void* x, const void* s, const void* b, void* out, long long m_rows, int ld, int c_live,
               int c_out, const void* bnd, int g, int relu, cudaStream_t stream) {
  const long long want = (m_rows * (c_out / 4) + THREADS - 1) / THREADS;
  const int ctas = static_cast<int>(want < MAX_CTAS ? (want > 0 ? want : 1) : MAX_CTAS);
  bn_act_kernel<T, MODE><<<ctas, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<uint32_t*>(out), m_rows, ld, c_live, c_out, static_cast<const float*>(bnd), g, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bn_act_dispatch(int mode, const void* x, const void* s, const void* b, void* out, long long m_rows, int ld,
                    int c_live, int c_out, const void* bnd, int g, int relu, cudaStream_t stream) {
  switch (mode) {
    case POLY: return bn_act_run<T, POLY>(x, s, b, out, m_rows, ld, c_live, c_out, bnd, g, relu, stream);
    case ERF: return bn_act_run<T, ERF>(x, s, b, out, m_rows, ld, c_live, c_out, bnd, g, relu, stream);
    case BINS: return bn_act_run<T, BINS>(x, s, b, out, m_rows, ld, c_live, c_out, bnd, g, relu, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int bn_act_launch(const void* x, int x_is_int8, const void* s, const void* b, void* out,
                             long long m_rows, int ld, int c_live, int c_out, int mode, const void* bnd, int g,
                             int relu, void* stream) {
  if (ld % 4 || c_live % 4 || c_out % 4 || c_live > ld || c_live > c_out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_int8) return bn_act_dispatch<int8_t>(mode, x, s, b, out, m_rows, ld, c_live, c_out, bnd, g, relu, st);
  return bn_act_dispatch<float>(mode, x, s, b, out, m_rows, ld, c_live, c_out, bnd, g, relu, st);
}

extern "C" int cdf_quant_launch(const void* x, void* out, long long n, void* stream) {
  const long long n4 = (n >> 2) > 0 ? (n >> 2) : 1;
  const long long want = (n4 + THREADS - 1) / THREADS;
  const int ctas = static_cast<int>(want < MAX_CTAS ? want : MAX_CTAS);
  cdf_quant_kernel<<<ctas, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
