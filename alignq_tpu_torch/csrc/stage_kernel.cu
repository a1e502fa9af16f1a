// K3: a run of stride-1 PreAct identity blocks on the int16 residual code
// stream, one CTA per image, for sm_90a.
//
// Replaces the TPU kernel alignq_tpu/kernels/stage_kernel.py:171
// stage_identity_blocks (body _stage_body). Per block, on the integer code
// stream K >= 0: requant x8 = clip((2K+m)//(2m), 0, g); 3x3 conv; f32
// scale/bias; poly act codes; relu; second 3x3 conv; codes; K = relu(a1 + K).
//
// What bounds it on an H100: the residual stream's bytes for stages 1-2
// (the int16 plane is read once and written once per run of blocks) and the
// int8 conv arithmetic for stage 3 (C=64 on 8x8 images: ~9C^2 MACs per
// stream element). What the design does about it: the whole image's int16
// plane sits in shared memory for all n blocks of the run and goes back to
// device memory once; requantized codes and the first conv's codes live in
// zero-bordered halo buffers in shared memory, so no intermediate of a block
// ever leaves the SM and the 3x3 taps need no bounds tests. The conv itself
// is a direct dp4a conv over 4 channels a word (simple first: the tensor
// cores would serve stage 3 better, which is work for a later change).
//
// The TPU kernel's (C, M) lane layout and int32 tap rolls were Mosaic
// workarounds and are not carried over: here codes are stored [pixel][C],
// so each thread reads a tap's 16 channels as one 16-byte load.
//
// Rounding rule: every f32 `a * b + c` is one rounding (__fmaf_rn), as the
// JAX graph's contracted multiply-adds under jit; rintf rounds half to even
// like jnp.round. The poly act codes are act_codes.cuh's poly_code, shared
// with K1's codes epilogue.
//
// C interface: stage_launch returns cudaGetLastError() after the launch.
// Requirements (checked by the Python wrapper): C in {16, 32, 64},
// H*W % 8 == 0, n_blocks <= MAX_BLOCKS.

#include <cuda_runtime.h>
#include <stdint.h>

#include "act_codes.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int COG = 16;  // output channels per work item
constexpr int MAX_BLOCKS = 32;

struct BlockMs {
  int v[MAX_BLOCKS];
};

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// One 3x3 pad-1 conv over the halo buffer xin ([(H+2)*(W+2)][C] int8 codes,
// zero border) with weights ws ([C_out][9][C_in] int8) in shared memory.
// FIRST: relu(codes) into the interior of the halo buffer xout.
// else : plane[co][p] = relu(codes + plane[co][p]), the residual add.
template <int C, bool FIRST>
__device__ void conv3x3(const int8_t* xin, const int8_t* ws,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, float gf, int H, int W,
                        int8_t* xout, int16_t* plane) {
  const int HW = H * W, Wp = W + 2;
  const int items = HW * (C / COG);
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int cog = it / HW, p = it - cog * HW;
    const int y = p / W, x = p - y * W;
    int acc[COG];
#pragma unroll
    for (int o = 0; o < COG; ++o) acc[o] = 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int8_t* src = xin + ((y + tap / 3) * Wp + x + tap % 3) * C;
#pragma unroll
      for (int c16 = 0; c16 < C / 16; ++c16) {
        const int4 xv = *reinterpret_cast<const int4*>(src + c16 * 16);
#pragma unroll
        for (int o = 0; o < COG; ++o) {
          const int4 wv = *reinterpret_cast<const int4*>(
              ws + (cog * COG + o) * 9 * C + tap * C + c16 * 16);
          int a = acc[o];
          a = __dp4a(xv.x, wv.x, a);
          a = __dp4a(xv.y, wv.y, a);
          a = __dp4a(xv.z, wv.z, a);
          a = __dp4a(xv.w, wv.w, a);
          acc[o] = a;
        }
      }
    }
    if (FIRST) {
      uint32_t packed[COG / 4];
#pragma unroll
      for (int q = 0; q < COG / 4; ++q) {
        uint32_t word = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int co = cog * COG + q * 4 + k;
          const float h = __fmaf_rn(static_cast<float>(acc[q * 4 + k]), scale[co], bias[co]);
          const int r = max(act::poly_code(h, gf), 0);
          word |= static_cast<uint32_t>(r & 0xff) << (8 * k);
        }
        packed[q] = word;
      }
      *reinterpret_cast<uint4*>(xout + ((y + 1) * Wp + x + 1) * C + cog * COG) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    } else {
#pragma unroll
      for (int o = 0; o < COG; ++o) {
        const int co = cog * COG + o;
        const float h = __fmaf_rn(static_cast<float>(acc[o]), scale[co], bias[co]);
        const int a1 = act::poly_code(h, gf);
        int16_t* k = plane + co * HW + p;
        *k = static_cast<int16_t>(max(a1 + static_cast<int>(*k), 0));
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS)
stage_kernel(const int16_t* __restrict__ stream_in, int16_t* __restrict__ stream_out,
             const int8_t* __restrict__ wt, const float* __restrict__ scale,
             const float* __restrict__ bias, BlockMs ms, int n_blocks, int g,
             int H, int W, int m_total) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HW = H * W, Wp = W + 2, HWp = (H + 2) * Wp;
  const int tid = threadIdx.x;
  int16_t* plane = reinterpret_cast<int16_t*>(smem);  // [C][HW] int16 codes
  int8_t* xa = reinterpret_cast<int8_t*>(smem + align16(2 * C * HW));  // halo
  int8_t* xb = xa + HWp * C;   // halo (HWp * C is a multiple of 16)
  int8_t* ws = xb + HWp * C;   // [C][9C] weights of the current conv
  const float gf = static_cast<float>(g);
  const int wbytes = 9 * C * C;

  // both halo buffers: zero once; only their interiors are written below
  for (int i = tid; i < 2 * HWp * C / 16; i += THREADS)
    reinterpret_cast<int4*>(xa)[i] = make_int4(0, 0, 0, 0);

  const size_t base = (size_t)blockIdx.x * HW;  // this CTA's image
  for (int i = tid; i < C * HW / 8; i += THREADS) {
    const int c = i / (HW / 8), q = i - c * (HW / 8);
    reinterpret_cast<int4*>(plane)[i] =
        *reinterpret_cast<const int4*>(stream_in + (size_t)c * m_total + base + q * 8);
  }
  __syncthreads();

  for (int b = 0; b < n_blocks; ++b) {
    const int m = ms.v[b];
    // requant the plane into xa's interior, and stage conv0's weights
    for (int p = tid; p < HW; p += THREADS) {
      const int y = p / W, x = p - y * W;
      int8_t* dst = xa + ((y + 1) * Wp + x + 1) * C;
#pragma unroll
      for (int c16 = 0; c16 < C / 16; ++c16) {
        uint32_t words[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t word = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int kk = plane[(c16 * 16 + q * 4 + k) * HW + p];
            // floor and truncation agree after the clip at 0
            const int v = (m == 1) ? kk : (2 * kk + m) / (2 * m);
            word |= static_cast<uint32_t>(min(max(v, 0), g)) << (8 * k);
          }
          words[q] = word;
        }
        *reinterpret_cast<uint4*>(dst + c16 * 16) =
            make_uint4(words[0], words[1], words[2], words[3]);
      }
    }
    const int8_t* w0 = wt + (size_t)(2 * b) * wbytes;
    for (int i = tid; i < wbytes / 16; i += THREADS)
      reinterpret_cast<int4*>(ws)[i] = reinterpret_cast<const int4*>(w0)[i];
    __syncthreads();

    conv3x3<C, true>(xa, ws, scale + (2 * b) * C, bias + (2 * b) * C, gf, H, W, xb, plane);
    __syncthreads();

    const int8_t* w1 = wt + (size_t)(2 * b + 1) * wbytes;
    for (int i = tid; i < wbytes / 16; i += THREADS)
      reinterpret_cast<int4*>(ws)[i] = reinterpret_cast<const int4*>(w1)[i];
    __syncthreads();

    conv3x3<C, false>(xb, ws, scale + (2 * b + 1) * C, bias + (2 * b + 1) * C, gf, H, W, xa, plane);
    __syncthreads();
  }

  for (int i = tid; i < C * HW / 8; i += THREADS) {
    const int c = i / (HW / 8), q = i - c * (HW / 8);
    *reinterpret_cast<int4*>(stream_out + (size_t)c * m_total + base + q * 8) =
        reinterpret_cast<const int4*>(plane)[i];
  }
}

template <int C>
int launch(const void* in, void* out, const void* wt, const void* scale,
           const void* bias, const BlockMs& ms, int n_blocks, int g, int H,
           int W, int batch, cudaStream_t stream) {
  const int HWp = (H + 2) * (W + 2);
  const int smem = align16(2 * C * H * W) + 2 * HWp * C + 9 * C * C;
  cudaError_t err = cudaFuncSetAttribute(
      stage_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stage_kernel<C><<<batch, THREADS, smem, stream>>>(
      static_cast<const int16_t*>(in), static_cast<int16_t*>(out),
      static_cast<const int8_t*>(wt), static_cast<const float*>(scale),
      static_cast<const float*>(bias), ms, n_blocks, g, H, W, batch * H * W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stage_smem_bytes(int C, int H, int W) {
  return align16(2 * C * H * W) + 2 * (H + 2) * (W + 2) * C + 9 * C * C;
}

extern "C" int stage_launch(const void* in, void* out, const void* wt,
                            const void* scale, const void* bias, const int* ms,
                            int n_blocks, int g, int C, int H, int W, int batch,
                            void* stream) {
  if (n_blocks > MAX_BLOCKS) return static_cast<int>(cudaErrorInvalidValue);
  BlockMs m{};
  for (int i = 0; i < n_blocks; ++i) m.v[i] = ms[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch<16>(in, out, wt, scale, bias, m, n_blocks, g, H, W, batch, s);
    case 32: return launch<32>(in, out, wt, scale, bias, m, n_blocks, g, H, W, batch, s);
    case 64: return launch<64>(in, out, wt, scale, bias, m, n_blocks, g, H, W, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
