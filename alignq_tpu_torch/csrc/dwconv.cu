// Depthwise 3x3 int8 conv (groups = C) with a fused dequant or act-code
// epilogue, for sm_90a: K1's depthwise form.
//
// Replaces the int8 depthwise conv that the JAX serving graph of
// MobileNet-V2 leaves to XLA (alignq_tpu/kernels/infer_mobilenet.py:39-49,
// conv_general_dilated with feature_group_count = planes), the conv of the
// TPU kernel K1's family (alignq_tpu/kernels/qmatmul.py:45
// int8_matmul_dequant): out[b, oy, ox, c] = epilogue(sum over the 9 taps of
// x[b, oy*s + dy - 1, ox*s + dx - 1, c] * w[dy, dx, c]) (zero off the
// image), pad 1, stride 1 or 2, int32 accumulation.
//
// What bounds it on an H100: bytes. One channel a group leaves an MMA
// nothing to contract over, and a 3x3 depthwise conv does 18 operations an
// output element against one input byte and one (codes) or four (f32)
// output bytes: far under the card's ridge, so the tensor cores are of no
// use and the kernel is a direct one that reads each input byte from
// device memory once (the 9 taps' re-reads hit L1/L2).
//
// What the design does about it:
// - Each thread of a grid-stride loop takes 4 channels of one output pixel:
//   one 32-bit load a tap, 4 int32 multiply-adds, neighbouring threads on
//   neighbouring channel quads of the pixel, so a warp reads 128
//   contiguous bytes a tap.
// - The (9, C) weight and the (C,) scale and bias sit in shared memory,
//   loaded once a CTA.
// - The 4 results leave as one 32-bit word (codes) or one 16-byte store
//   (f32, int32).
//
// Epilogue rule, as K1's: f32 `acc * scale + bias` is one rounding
// (__fmaf_rn); the codes are act_codes.cuh's poly, erf or bins maps of it,
// with max(code, 0) where relu is set.
//
// C interface: dw_conv_launch returns cudaGetLastError() after the launch.
// Requirements (checked by the Python wrapper, kernels/dwconv.py): x (B, H,
// W, C) int8 contiguous and 16-byte aligned, C % 4 == 0; w (9, C) int8;
// scale and bias (C,) f32; out (B, Ho, Wo, C) of the mode's type.

#include <cuda_runtime.h>
#include <stdint.h>

#include "act_codes.cuh"

namespace {

constexpr int THREADS = 256;

// Epilogue modes (the wrapper's kernels/dwconv.py _MODE)
enum Mode { INT32 = 0, F32 = 1, POLY = 3, ERF = 4, BINS = 5 };

struct DwArgs {
  int B, H, W, C, Ho, Wo, stride;
  const float* bnd;  // BINS: the g f32 erf-grid boundaries
  int g, relu;
};

__device__ __forceinline__ int sbyte(uint32_t v, int j) {
  return static_cast<int>(static_cast<int8_t>((v >> (8 * j)) & 0xff));
}

template <int MODE>
__device__ __forceinline__ int dw_code(int acc, float s, float b, const DwArgs& a) {
  const float h = __fmaf_rn(static_cast<float>(acc), s, b);
  const float gf = static_cast<float>(a.g);
  int code;
  if (MODE == POLY) code = act::poly_code(h, gf);
  else if (MODE == ERF) code = act::erf_code(h, gf);
  else code = act::bins_code(h, a.bnd, a.g);
  return a.relu ? max(code, 0) : code;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
dw_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               void* __restrict__ out, const DwArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_scale = reinterpret_cast<float*>(smem);
  float* s_bias = s_scale + a.C;
  uint32_t* s_w = reinterpret_cast<uint32_t*>(s_bias + a.C);  // (9, C / 4) words
  const int quads = a.C / 4;
  for (int i = threadIdx.x; i < a.C; i += blockDim.x) {
    s_scale[i] = scale[i];
    s_bias[i] = bias[i];
  }
  const uint32_t* w4 = reinterpret_cast<const uint32_t*>(w);
  for (int i = threadIdx.x; i < 9 * quads; i += blockDim.x) s_w[i] = w4[i];
  __syncthreads();

  const long long items = static_cast<long long>(a.B) * a.Ho * a.Wo * quads;
  for (long long item = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; item < items;
       item += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long m = item / quads;
    const int q = static_cast<int>(item - m * quads);
    const int ox = static_cast<int>(m % a.Wo);
    const long long r = m / a.Wo;
    const int oy = static_cast<int>(r % a.Ho);
    const int b = static_cast<int>(r / a.Ho);
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int iy = oy * a.stride + dy - 1;
      if (static_cast<unsigned>(iy) >= static_cast<unsigned>(a.H)) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ix = ox * a.stride + dx - 1;
        if (static_cast<unsigned>(ix) >= static_cast<unsigned>(a.W)) continue;
        const uint32_t xv = *reinterpret_cast<const uint32_t*>(
            x + ((static_cast<size_t>(b) * a.H + iy) * a.W + ix) * a.C + 4 * q);
        const uint32_t wv = s_w[(dy * 3 + dx) * quads + q];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] += sbyte(xv, j) * sbyte(wv, j);
      }
    }
    const int c = 4 * q;
    if (MODE == INT32) {
      reinterpret_cast<int4*>(out)[item] = make_int4(acc[0], acc[1], acc[2], acc[3]);
    } else if (MODE == F32) {
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = __fmaf_rn(static_cast<float>(acc[j]), s_scale[c + j], s_bias[c + j]);
      reinterpret_cast<float4*>(out)[item] = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word |= (static_cast<uint32_t>(dw_code<MODE>(acc[j], s_scale[c + j], s_bias[c + j], a)) & 0xff) << (8 * j);
      reinterpret_cast<uint32_t*>(out)[item] = word;
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <int MODE>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* out, const DwArgs& a,
           cudaStream_t stream) {
  const int smem = 8 * a.C + 9 * a.C;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(a.B) * a.Ho * a.Wo * (a.C / 4);
  const long long want = (items + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sm_count()) * 8;  // 8 CTAs of 256 threads an SM
  const int grid = static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
  dw_conv_kernel<MODE><<<grid, THREADS, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), out, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dw_conv_launch(const void* x, const void* w, const void* scale, const void* bias, void* out,
                              int B, int H, int W, int C, int stride, int mode, const void* bnd, int g,
                              int relu, void* stream) {
  if (C % 4 || (stride != 1 && stride != 2)) return static_cast<int>(cudaErrorInvalidValue);
  const DwArgs a{B, H, W, C, (H - 1) / stride + 1, (W - 1) / stride + 1, stride,
                 static_cast<const float*>(bnd), g, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case INT32: return launch<INT32>(x, w, scale, bias, out, a, s);
    case F32: return launch<F32>(x, w, scale, bias, out, a, s);
    case POLY: return launch<POLY>(x, w, scale, bias, out, a, s);
    case ERF: return launch<ERF>(x, w, scale, bias, out, a, s);
    case BINS: return launch<BINS>(x, w, scale, bias, out, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
