// K3: a run of stride-1 PreAct identity blocks on the int16 residual code
// stream, one CTA per image, convs on the tensor cores, for sm_90a.
//
// Replaces the TPU kernel alignq_tpu/kernels/stage_kernel.py:171
// stage_identity_blocks (body _stage_body). Per block, on the integer code
// stream K >= 0: requant x8 = clip((2K+m)//(2m), 0, g); 3x3 conv; f32
// scale/bias; poly act codes; relu; second 3x3 conv; codes; K = relu(a1 + K).
//
// What bounds it on an H100: the residual stream's bytes (the int16 plane
// read once and written once a run of blocks) against the int8 conv
// arithmetic, 2 convs a block of 2*9*C*C operations a pixel: at C=16 and 32
// bytes bound it, at C=64 (stage 3) operations do. Past both, the f32
// epilogue (poly act code, ~25 instructions a code, on the CUDA cores) is
// of the same order as the MMAs at C=16.
//
// What the design does about it:
// - The whole image's int16 plane sits in shared memory for all n blocks
//   of the run, stored [pixel][C] as the stream is in device memory, (B*H*W,
//   C) int16: an image is one contiguous run of bytes, loaded and stored
//   with 16-byte vectors (the load by cp.async).
// - Requantized codes and the first conv's codes live in zero-bordered halo
//   buffers ([(H+2)*(W+2)] pixels at a pitch P), so no intermediate of a
//   block leaves the SM and the 3x3 taps need no bounds tests.
// - Each 3x3 conv is an implicit GEMM over the halo buffer: M = H*W pixels,
//   N = C, K = 9C padded to 32, on mma.sync m16n8k32 s8. A fragments are
//   read from the halo buffer at a per-k-word tap offset (a table), B from
//   the staged weights. P (16, 48, 80 bytes at C = 16, 32, 64) and the
//   weight pitch WP = Kp + 16 have P/4 and WP/4 = 4 mod 8 words, so the 8
//   rows g of a fragment load fall on 8 distinct groups of 4 banks.
// - The next conv's weights are staged by cp.async into the other of two
//   buffers while the current conv (and the requant before it) runs.
// - Warps split M and N: C=16, 2 m16 x 2 n8 a unit; C=32, 2 m16 x 4 n8;
//   C=64, 1 m16 x 4 n8 (8 units for the 8 warps on an 8x8 image).
//
// The TPU kernel's (C, M) lane layout and int32 tap rolls were Mosaic
// workarounds and are not carried over.
//
// Shared memory (stage_smem_bytes) and CTAs an SM (228 KB, 1 KB reserved a
// CTA): C=16 at 32x32, 75,552 bytes, 3 CTAs; C=32 at 16x16, 67,232 bytes,
// 3 CTAs; C=64 at 8x8, 100,544 bytes, 2 CTAs.
//
// Rounding rule: every f32 `a * b + c` is one rounding (__fmaf_rn), as the
// JAX graph's contracted multiply-adds under jit; rintf rounds half to even
// like jnp.round. The poly act codes are act_codes.cuh's poly_code, shared
// with K1's codes epilogue.
//
// C interface: stage_launch returns cudaGetLastError() after the launch.
// Requirements (checked by the Python wrapper): C in {16, 32, 64}, the
// stream (B*H*W, C) int16 and weights (n_blocks, 2, C, 9C) int8 contiguous
// and 16-byte aligned, n_blocks <= MAX_BLOCKS.

#include <cuda_runtime.h>
#include <stdint.h>

#include "act_codes.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 32;

struct BlockMs {
  int v[MAX_BLOCKS];
};

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// The tiling of each width: MT m16 x NT n8 MMA tiles a warp's unit, the
// halo pixel pitch P, the padded depth KP and the weight row pitch WP.
template <int C>
struct Cfg {
  static constexpr int MT = C == 64 ? 1 : 2;
  static constexpr int NT = C == 16 ? 2 : 4;
  static constexpr int P = C == 16 ? 16 : (C == 32 ? 48 : 80);
  static constexpr int KP = (9 * C + 31) / 32 * 32;
  static constexpr int WP = KP + 16;
};

__host__ __device__ constexpr int smem_bytes(int C, int P, int WP, int KP, int H, int W) {
  return align16(2 * H * W * C) + 2 * align16((H + 2) * (W + 2) * P) + 2 * C * WP + KP;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// a / d, by a shift where d is a power of two (dlog2 >= 0): the image
// widths of the path are, and an integer division costs tens of instructions
__device__ __forceinline__ int div_by(int a, int d, int dlog2) { return dlog2 >= 0 ? a >> dlog2 : a / d; }

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage conv weights w ([C_out][9 C_in] int8 in device memory) into ws
// (rows at pitch WP; the padding columns stay zero).
template <int C>
__device__ void stage_weights(int8_t* ws, const int8_t* __restrict__ w) {
  constexpr int ROW16 = 9 * C / 16;
  for (int i = threadIdx.x; i < C * ROW16; i += THREADS) {
    const int n = i / ROW16, q = i - n * ROW16;
    cp_async16(ws + n * Cfg<C>::WP + q * 16, w + n * 9 * C + q * 16);
  }
  cp_commit();
}

// One 3x3 pad-1 conv over the halo buffer xin as an implicit GEMM on the
// tensor cores, weights ws in shared memory, koff the A byte offset of each
// k-word relative to a pixel's top-left tap.
// FIRST: relu(codes) into the interior of the halo buffer xout.
// else : plane[p][co] = relu(codes + plane[p][co]), the residual add.
template <int C, bool FIRST>
__device__ void conv3x3(const int8_t* xin, const int8_t* ws, const int* koff,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        float gf, int H, int W, int8_t* xout, int16_t* plane) {
  using K = Cfg<C>;
  constexpr int MT = K::MT, NT = K::NT, P = K::P, WP = K::WP;
  constexpr int NGROUPS = C / (8 * NT);
  const int HW = H * W, Wp = W + 2;
  const int w_log2 = (W & (W - 1)) == 0 ? __ffs(W) - 1 : -1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // MMA fragment group / thread
  const int mgroups = (HW + 16 * MT - 1) / (16 * MT);

  for (int u = warp; u < mgroups * NGROUPS; u += WARPS) {
    const int mg = u / NGROUPS, n0 = (u - mg * NGROUPS) * NT * 8;
    int pix[MT][2], base[MT][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (mg * MT + mi) * 16 + g + 8 * h;
        pix[mi][h] = p;
        const int y = div_by(p, W, w_log2), x = p - y * W;
        base[mi][h] = p < HW ? (y * Wp + x) * P : 0;  // past the image: read, not stored
      }
    int acc[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0;

#pragma unroll 3
    for (int ks = 0; ks < K::KP / 32; ++ks) {
      const int o0 = koff[ks * 8 + t], o1 = koff[ks * 8 + 4 + t];
      uint32_t af[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        af[mi][0] = lds32(xin + base[mi][0] + o0);
        af[mi][1] = lds32(xin + base[mi][1] + o0);
        af[mi][2] = lds32(xin + base[mi][0] + o1);
        af[mi][3] = lds32(xin + base[mi][1] + o1);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* b = ws + (n0 + j * 8 + g) * WP + ks * 32 + 4 * t;
        const uint32_t b0 = lds32(b), b1 = lds32(b + 16);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) mma_s8(acc[mi][j], af[mi], b0, b1);
      }
    }

    // C fragment: (pixel g, channels 2t, 2t+1) in acc[..][0..1], g+8 in [2..3]
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int co = n0 + j * 8 + 2 * t;
      const float s0 = scale[co], s1 = scale[co + 1], c0 = bias[co], c1 = bias[co + 1];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = pix[mi][h];
          if (p >= HW) continue;
          const float h0 = __fmaf_rn(static_cast<float>(acc[mi][j][2 * h]), s0, c0);
          const float h1 = __fmaf_rn(static_cast<float>(acc[mi][j][2 * h + 1]), s1, c1);
          if (FIRST) {
            const int y = div_by(p, W, w_log2), x = p - y * W;
            const int r0 = max(act::poly_code(h0, gf), 0), r1 = max(act::poly_code(h1, gf), 0);
            *reinterpret_cast<uint16_t*>(xout + ((y + 1) * Wp + x + 1) * P + co) =
                static_cast<uint16_t>(r0 | r1 << 8);
          } else {
            uint32_t* k = reinterpret_cast<uint32_t*>(plane + p * C + co);
            const uint32_t old = *k;
            const int k0 = static_cast<int16_t>(old & 0xffff), k1 = static_cast<int16_t>(old >> 16);
            const int v0 = max(act::poly_code(h0, gf) + k0, 0), v1 = max(act::poly_code(h1, gf) + k1, 0);
            *k = static_cast<uint32_t>(v0 & 0xffff) | static_cast<uint32_t>(v1) << 16;
          }
        }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS)
stage_kernel(const int16_t* __restrict__ stream_in, int16_t* __restrict__ stream_out,
             const int8_t* __restrict__ wt, const float* __restrict__ scale,
             const float* __restrict__ bias, BlockMs ms, int n_blocks, int g, int H, int W) {
  using K = Cfg<C>;
  constexpr int P = K::P, WP = K::WP, KP = K::KP;
  extern __shared__ __align__(16) unsigned char smem[];
  const int HW = H * W, Wp = W + 2, HWp = (H + 2) * Wp;
  const int tid = threadIdx.x;
  int16_t* plane = reinterpret_cast<int16_t*>(smem);                    // [HW][C] int16 codes
  int8_t* xa = reinterpret_cast<int8_t*>(smem + align16(2 * HW * C));  // halo
  int8_t* xb = xa + align16(HWp * P);                                   // halo
  int8_t* ws0 = xb + align16(HWp * P);                                  // [C][WP] weights
  int8_t* ws1 = ws0 + C * WP;
  int* koff = reinterpret_cast<int*>(ws1 + C * WP);                    // [KP / 4]
  const float gf = static_cast<float>(g);
  const int wbytes = 9 * C * C;
  const int w_log2 = (W & (W - 1)) == 0 ? __ffs(W) - 1 : -1;

  // this CTA's image, one contiguous run of the stream; conv 0's weights
  const int16_t* img_in = stream_in + static_cast<size_t>(blockIdx.x) * HW * C;
  for (int i = tid; i < HW * C / 8; i += THREADS) cp_async16(plane + i * 8, img_in + i * 8);
  stage_weights<C>(ws0, wt);

  // both halo buffers: zero once, only their interiors are written below;
  // the weights' padding columns likewise
  for (int i = tid; i < 2 * align16(HWp * P) / 16; i += THREADS)
    reinterpret_cast<int4*>(xa)[i] = make_int4(0, 0, 0, 0);
  constexpr int PAD_WORDS = (KP - 9 * C) / 4;  // 4 at C=16, 0 above
  if (PAD_WORDS > 0) {
    for (int i = tid; i < 2 * C * PAD_WORDS; i += THREADS) {
      const int row = i / (PAD_WORDS > 0 ? PAD_WORDS : 1), q = i - row * PAD_WORDS;
      *reinterpret_cast<int*>(ws0 + row * WP + 9 * C + 4 * q) = 0;  // rows of ws0, then ws1
    }
  }
  // word q of K holds k = 4q..4q+3: tap k / C, channels k % C..; the
  // zero-weight tail repeats the last real word
  for (int q = tid; q < KP / 4; q += THREADS) {
    const int k = 4 * q, tap = k / C, c = k - tap * C;
    koff[q] = tap < 9 ? ((tap / 3) * Wp + tap % 3) * P + c : (2 * Wp + 2) * P + C - 4;
  }

  for (int b = 0; b < n_blocks; ++b) {
    const int m = ms.v[b];
    cp_wait_all();  // the plane (block 0) and conv0's weights in ws0
    __syncthreads();
    stage_weights<C>(ws1, wt + static_cast<size_t>(2 * b + 1) * wbytes);  // conv1's, meanwhile
    // requant the plane into xa's interior, 8 channels of a pixel at a time
    for (int i = tid; i < HW * C / 8; i += THREADS) {
      const int p = i / (C / 8), c8 = i - p * (C / 8);
      const int y = div_by(p, W, w_log2), x = p - y * W;
      const int4 v = reinterpret_cast<const int4*>(plane)[i];
      const int pairs[4] = {v.x, v.y, v.z, v.w};  // 2 int16 codes each, low half first
      uint32_t words[2] = {0, 0};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = static_cast<int16_t>(pairs[e >> 1] >> (16 * (e & 1)));
        // floor and truncation agree after the clip at 0
        const int q = (m == 1) ? k : (2 * k + m) / (2 * m);
        words[e >> 2] |= static_cast<uint32_t>(min(max(q, 0), g)) << (8 * (e & 3));
      }
      *reinterpret_cast<uint2*>(xa + ((y + 1) * Wp + x + 1) * P + c8 * 8) = make_uint2(words[0], words[1]);
    }
    __syncthreads();

    conv3x3<C, true>(xa, ws0, koff, scale + (2 * b) * C, bias + (2 * b) * C, gf, H, W, xb, plane);
    cp_wait_all();  // conv1's weights
    __syncthreads();
    if (b + 1 < n_blocks) stage_weights<C>(ws0, wt + static_cast<size_t>(2 * b + 2) * wbytes);

    conv3x3<C, false>(xb, ws1, koff, scale + (2 * b + 1) * C, bias + (2 * b + 1) * C, gf, H, W, xa, plane);
  }
  __syncthreads();

  int16_t* img_out = stream_out + static_cast<size_t>(blockIdx.x) * HW * C;
  for (int i = tid; i < HW * C / 8; i += THREADS)
    reinterpret_cast<int4*>(img_out)[i] = reinterpret_cast<const int4*>(plane)[i];
}

template <int C>
int smem_of(int H, int W) {
  using K = Cfg<C>;
  return smem_bytes(C, K::P, K::WP, K::KP, H, W);
}

template <int C>
int launch(const void* in, void* out, const void* wt, const void* scale,
           const void* bias, const BlockMs& ms, int n_blocks, int g, int H,
           int W, int batch, cudaStream_t stream) {
  const int smem = smem_of<C>(H, W);
  cudaError_t err = cudaFuncSetAttribute(
      stage_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stage_kernel<C><<<batch, THREADS, smem, stream>>>(
      static_cast<const int16_t*>(in), static_cast<int16_t*>(out),
      static_cast<const int8_t*>(wt), static_cast<const float*>(scale),
      static_cast<const float*>(bias), ms, n_blocks, g, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stage_smem_bytes(int C, int H, int W) {
  switch (C) {
    case 16: return smem_of<16>(H, W);
    case 32: return smem_of<32>(H, W);
    case 64: return smem_of<64>(H, W);
    default: return -1;
  }
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
