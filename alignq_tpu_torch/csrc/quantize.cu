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

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

extern "C" int cdf_quant_launch(const void* x, void* out, long long n, void* stream) {
  const long long n4 = (n >> 2) > 0 ? (n >> 2) : 1;
  const long long want = (n4 + THREADS - 1) / THREADS;
  const int ctas = static_cast<int>(want < MAX_CTAS ? want : MAX_CTAS);
  cdf_quant_kernel<<<ctas, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
