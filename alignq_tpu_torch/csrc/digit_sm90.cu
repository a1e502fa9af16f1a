// The digit DANN's two 5x5 VALID convs on Hopper, each with its act codes
// and the 2x2 stride-2 max pool after it, in one wgmma kernel, for sm_90a.
//
// Replaces, in the digit net, the TPU kernel alignq_tpu/kernels/qmatmul.py:45
// int8_matmul_dequant as the port ran it (K1's 5x5 form, qmatmul.cu) with
// XLA's int8 conv and reduce_window around it (the JAX serving graph,
// alignq_tpu/kernels/infer_digit.py mnist_dann_int8_forward: conv_block's
// conv_general_dilated at :111, _erfq_codes, max and reduce_window at
// :124). It computes what the chain K1 (relu'd codes mode) then the 2x2
// max pool of the codes computes, bit for bit:
//     pooled[b, py, px, n] = max over the 2x2 window of max(code(acc * s[n]
//     + b[n]), 0),
// acc the int32 conv sum, code the erf or poly map (through its step
// table, act_codes.cuh table_code) or the A4 bins map, stored int8:
// - conv1: the image (B, 28, 28, 4 channels) to 32 channels, pooled to
//   (B, 12, 12, 32); it reads the stem's prep pass's layout (stem_sm90.cu
//   stem_prep_kernel at the digit scale: rows of 32 pixels, the image's 28
//   from pixel 3);
// - conv2: conv1's pooled codes (B, 12, 12, 32) to 48 channels, pooled to
//   (B, 4, 4, 48).
//
// What bounds it on an H100: bytes, the int8 image in and the pooled codes
// out (about 1 us over both convs at batch 256); its 2 * M * K * N int8
// operations take less. What the chain spent its time on (PERF.md):
// conv1 writing 147,456 x 32 codes at 256 that the pool read back to keep
// one in four; the erf map's ~40 issue slots, a division among them, on
// every conv output; conv2's tile of one 8x8 image a CTA, its band, 25 K
// steps and epilogue in series, on mma.sync; and the glue passes around
// it (the pad to 4 channels, the two pools).
//
// What the design does about it:
// - Persistent CTAs walk tiles of IMG whole images, which come into a ring
//   of S stages, S - 1 tiles ahead: conv1's by one 1-D bulk copy (an image
//   is 3,584 bytes), conv2's by two 3-D TMA boxes (16 bytes, 144 pixels at
//   32 bytes, images), one from each 16-byte half of a pixel's 32 channels,
//   so that the tile lies in shared memory as two planes of 16 bytes a
//   pixel. The re-packed weight (4 KB, 37.5 KB) comes once a CTA by one
//   bulk copy; B is read by descriptor.
// - conv1: wgmma m64n32k32, K = 25 taps x 4 channels in 4 K steps of 8 taps
//   (taps 25..31 against zero weights), A from registers: neighbouring
//   outputs are 4 bytes apart, which no descriptor takes, so each lane
//   loads its 4-byte taps (a tap is one pixel's 4 channels). The M order is
//   the pool's: row m of an image is conv output (2 py + wy, 2 px + wx) for
//   m = 4 (12 py + px) + 2 wy + wx, so a pool window is 4 neighbouring rows
//   of the accumulator, held by lanes l, l ^ 4, l ^ 8 and l ^ 12. An image
//   is 9 m64 groups. (A layout whose A loads hit 32 banks, kernel row t in
//   lane t at a row pitch of 40 words, 5 K steps, measured no faster:
//   PERF.md.)
// - conv2: wgmma m64n48k32 with A by descriptor: in a plane, 8 neighbouring
//   outputs of a row read 8 pixels 16 bytes apart, a core matrix; the next
//   output row is 12 pixels (192 bytes) on, the other half of a tap's 32
//   channels a plane (IMG x 2,304 bytes) on; so each of the 25 taps (K
//   steps) is a start address. An image is one m64.
// - The epilogue pools before it maps, as the stem kernel does: in
//   registers, the largest (or, where its column's scale is negative, the
//   least) sum of each window by a reduce-scatter of shuffles (and, for
//   conv2, the window's two rows in one thread) that leaves each lane the
//   columns it maps, then ONE __fmaf_rn and code a pooled output,
//   4x fewer maps: h rounds monotonically in acc, and the relu'd map is
//   non-decreasing but inside its few-ulp windows (act_codes.cuh
//   table_code). Where a pooled h lies in a window, the code is the largest
//   of the window's four sums' own (a warp-uniform branch, rarely taken).
//   The lanes that share a window split its columns, so no map is made
//   twice. Codes go through shared memory and out by one 1-D bulk store a
//   tile.
//
// C interface: digit_launch returns cudaGetLastError() after the launch,
// or the error that refused it. The wrapper (kernels/digit.py) checks the
// operands and computes the plan.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "act_codes.cuh"
#include "k1_epilogue.cuh"
#include "sm90_common.cuh"

namespace {

using namespace sm90;
using k1::BINS;
using k1::ERF;
using k1::POLY;

constexpr int MAX_THREADS = 512;
constexpr int MAX_STAGES = 8;
constexpr int TABLE_ROOM = 512;  // a relu'd table's entries at most: the buckets of [0, 4)
constexpr unsigned FULL = 0xffffffffu;

// conv1: image rows of 32 pixels x 4 bytes (the image's pixel x at pixel
// x + 3), 28 rows; 24 x 24 outputs, pooled 12 x 12 x 32; K in 4 steps of 32
constexpr int C1_ROW = 128, C1_IN = 28 * C1_ROW, C1_OUT = 144 * 32, C1_STEPS = 4, C1_STEP = 32 * 32;
// conv2: 144 pixels x 16 bytes in each of two planes (a tile's images' first
// halves, then their second); 8 x 8 outputs, pooled 4 x 4 x 48
constexpr int C2_PLANE = 144 * 16, C2_IN = 2 * C2_PLANE, C2_OUT = 16 * 48, C2_STEP = 48 * 32;

// The launch plan, in the order kernels/digit.py DigitPlan lays it out.
// Offsets of the shared-memory regions are from the dynamic shared
// memory's base.
struct Plan {
  int conv, B, N, IMG, n_wg, S, n_tiles, ctas;  // 1 or 2; images; channels out; images a tile; warpgroups; stages
  int in_bytes, out_bytes, w_bytes, groups;     // an image in, its pooled codes out; the weight; m64s an image
  int w_off, stage_off, stage_bytes, out_off, obuf_bytes, tab_off, sb_off, bar_off, smem;
};
constexpr int PLAN_INTS = sizeof(Plan) / sizeof(int);

// Tile `tile`'s images into the stage st, completing on bar (thread 0)
template <int CONV>
__device__ __forceinline__ void issue_images(const Plan& p, const CUtensorMap* map0, const CUtensorMap* map1,
                                             const int8_t* xq, unsigned char* st, uint64_t* bar, int tile) {
  const int b0 = tile * p.IMG;
  if (CONV == 1) {
    const uint32_t bytes = static_cast<uint32_t>(min(p.IMG, p.B - b0)) * C1_IN;
    mbar_arrive_expect_tx(bar, bytes);
    bulk_load(st, xq + static_cast<size_t>(b0) * C1_IN, bytes, bar);
  } else {  // the whole boxes, images past B zero-filled
    mbar_arrive_expect_tx(bar, static_cast<uint32_t>(p.IMG) * C2_IN);
    tma_load_3d(st, map0, bar, 0, 0, b0);
    tma_load_3d(st + p.IMG * C2_PLANE, map1, bar, 0, 0, b0);
  }
}

// The code of a pooled sum (the window's largest h), relu'd: through the
// table (win: whether h lies in one of its windows) or the bins compares
template <int MODE>
__device__ __forceinline__ int pooled_code(int acc, float s, float b, const int2* tab, const act::Table& t,
                                           const float* bnd, int g, bool& win) {
  const float h = __fmaf_rn(static_cast<float>(acc), s, b);
  if (MODE == BINS) {
    win = false;
    return max(act::bins_code(h, bnd, g), 0);
  }
  const int2 e = act::table_entry(h, tab, t.b_lo, t.n);
  win = act::in_window(h, e);
  return act::table_step_code<true>(h, e, t.lo, t.hi, g);
}

// A sum's own relu'd code by the direct map (the windows' path)
template <int MODE>
__device__ __noinline__ int own_code(int acc, float s, float b, int g) {
  const float h = __fmaf_rn(static_cast<float>(acc), s, b);
  const float gf = static_cast<float>(g);
  return max(MODE == ERF ? act::erf_code(h, gf) : act::poly_code(h, gf), 0);
}

__device__ __forceinline__ int pool2(int a, int b, bool neg) { return neg ? min(a, b) : max(a, b); }

// conv1, m64 group gg of an image: products, pool, codes into dst (the
// image's pooled codes, 144 x 32)
template <int MODE>
__device__ __forceinline__ void conv1_group(const unsigned char* img, uint64_t desc_w, int gg, unsigned char* dst,
                                            const float* sc, const int2* tab, const act::Table& table,
                                            const float* bnd, int g, int wq, int gq, int t) {
  // the lane's rows 16 wq + gq + 8h: pooled output P(h), window position gq & 3
  int off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int P = 16 * gg + 4 * wq + (gq >> 2) + 2 * h, py = P / 12, px = P - 12 * py;
    off[h] = (2 * py + ((gq >> 1) & 1)) * C1_ROW + 4 * (2 * px + (gq & 1) + 3);
  }
  // K step s: words t and 4 + t of each row are taps 8s + t and 8s + 4 + t
  uint32_t a[C1_STEPS][4];
#pragma unroll
  for (int s = 0; s < C1_STEPS; ++s) {
    const int j0 = 8 * s + t, j1 = 8 * s + 4 + t;
    const int o0 = j0 < 25 ? (j0 / 5) * C1_ROW + 4 * (j0 % 5) : 0;  // taps past 24: zero weights, any pixel
    const int o1 = j1 < 25 ? (j1 / 5) * C1_ROW + 4 * (j1 % 5) : 0;
    a[s][0] = *reinterpret_cast<const uint32_t*>(img + off[0] + o0);
    a[s][1] = *reinterpret_cast<const uint32_t*>(img + off[1] + o0);
    a[s][2] = *reinterpret_cast<const uint32_t*>(img + off[0] + o1);
    a[s][3] = *reinterpret_cast<const uint32_t*>(img + off[1] + o1);
  }
  int acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) reg_fence(acc[i]);
  __syncwarp();  // wgmma is .aligned: the warp converged after its waits
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < C1_STEPS; ++s) wgmma_rs<32>(acc, a[s], desc_w + ((s * C1_STEP) >> 4), s);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 16; ++i) reg_fence(acc[i]);
#pragma unroll
  for (int s = 0; s < C1_STEPS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) reg_fence(a[s][i]);
  // accumulator 4j + 2h + v: row 16 wq + gq + 8h, column 8j + 2t + v. The
  // window's sums are lanes l, l ^ 4, l ^ 8, l ^ 12, and lane k = gq & 3
  // maps column block j = k: a reduce-scatter over them, at xor 4 each lane
  // keeping the blocks of its bit 0 and sending the others, at xor 8 those
  // of its bit 1
  const int k = gq & 3, b0 = k & 1, b1 = k >> 1;
  int pooled[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      int p1[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int lo = acc[8 * jj + 2 * h + v], hi = acc[8 * jj + 4 + 2 * h + v];  // blocks 2jj, 2jj + 1
        const int sent = __shfl_xor_sync(FULL, b0 ? lo : hi, 4);
        p1[jj] = pool2(b0 ? hi : lo, sent, sc[8 * (2 * jj + b0) + 2 * t + v] < 0.f);
      }
      const int sent = __shfl_xor_sync(FULL, b1 ? p1[0] : p1[1], 8);
      pooled[h][v] = pool2(b1 ? p1[1] : p1[0], sent, sc[8 * k + 2 * t + v] < 0.f);
    }
  int code[2][2];
  unsigned in = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int col = 8 * k + 2 * t + v;
      bool win;
      code[h][v] = pooled_code<MODE>(pooled[h][v], sc[col], sc[32 + col], tab, table, bnd, g, win);
      in |= static_cast<unsigned>(win) << (2 * h + v);
    }
  if (MODE != BINS && __any_sync(FULL, in != 0)) {  // a pooled h in a window: the largest of the sums' own codes
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int col = 8 * j + 2 * t + v;
          int c = own_code<MODE>(acc[4 * j + 2 * h + v], sc[col], sc[32 + col], g);
          c = max(c, __shfl_xor_sync(FULL, c, 4));
          c = max(c, __shfl_xor_sync(FULL, c, 8));
          if (k == j && ((in >> (2 * h + v)) & 1)) code[h][v] = c;
        }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int P = 16 * gg + 4 * wq + (gq >> 2) + 2 * h;
    *reinterpret_cast<uint16_t*>(dst + P * 32 + 8 * k + 2 * t) =
        static_cast<uint16_t>((code[h][0] & 0xff) | (code[h][1] & 0xff) << 8);
  }
}

// conv2, one image (one m64; img its first plane, the second `plane`
// bytes on): products, pool, codes into dst (the image's pooled codes, 16
// x 48)
template <int MODE>
__device__ __forceinline__ void conv2_image(const unsigned char* img, int plane, uint64_t desc_w, unsigned char* dst,
                                            const float* sc, const int2* tab, const act::Table& table,
                                            const float* bnd, int g, int wq, int gq, int t) {
  // A of tap (dy, dx): core matrix (output row oy, K half h) at img + h
  // plane + ((oy + dy) 12 + dx) 16: the next output row 192 bytes on
  const uint64_t desc_a = make_desc_strided(img, plane, 12 * 16);
  int acc[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) reg_fence(acc[i]);
  __syncwarp();
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 25; ++j)
    wgmma_ss<48>(acc, desc_a + ((((j / 5) * 12 + j % 5) * 16) >> 4), desc_w + ((j * C2_STEP) >> 4), j);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 24; ++i) reg_fence(acc[i]);
  // accumulator 4j + 2h + v: output (2 wq + h, gq), column 8j + 2t + v. The
  // window's sums: h = 0, 1 here and lane l ^ 4, and lane k = gq & 1 maps
  // blocks 3k .. 3k + 2: it keeps those and sends the others
  const int k = gq & 1;
  int pooled[3][2];
#pragma unroll
  for (int jj = 0; jj < 3; ++jj)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int lo = pool2(acc[4 * jj + v], acc[4 * jj + 2 + v], sc[8 * jj + 2 * t + v] < 0.f);
      const int hi = pool2(acc[4 * (jj + 3) + v], acc[4 * (jj + 3) + 2 + v], sc[8 * (jj + 3) + 2 * t + v] < 0.f);
      const int sent = __shfl_xor_sync(FULL, k ? lo : hi, 4);
      pooled[jj][v] = pool2(k ? hi : lo, sent, sc[8 * (3 * k + jj) + 2 * t + v] < 0.f);
    }
  int code[3][2];
  unsigned in = 0;
#pragma unroll
  for (int jj = 0; jj < 3; ++jj)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int col = 8 * (3 * k + jj) + 2 * t + v;
      bool win;
      code[jj][v] = pooled_code<MODE>(pooled[jj][v], sc[col], sc[48 + col], tab, table, bnd, g, win);
      in |= static_cast<unsigned>(win) << (2 * jj + v);
    }
  if (MODE != BINS && __any_sync(FULL, in != 0)) {
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int col = 8 * j + 2 * t + v;
        int c = max(own_code<MODE>(acc[4 * j + v], sc[col], sc[48 + col], g),
                    own_code<MODE>(acc[4 * j + 2 + v], sc[col], sc[48 + col], g));
        c = max(c, __shfl_xor_sync(FULL, c, 4));
        const int jj = j - 3 * k;
        if (jj >= 0 && jj < 3 && ((in >> (2 * jj + v)) & 1)) code[jj][v] = c;
      }
  }
  const int P = 4 * wq + (gq >> 1);
#pragma unroll
  for (int jj = 0; jj < 3; ++jj)
    *reinterpret_cast<uint16_t*>(dst + P * 48 + 8 * (3 * k + jj) + 2 * t) =
        static_cast<uint16_t>((code[jj][0] & 0xff) | (code[jj][1] & 0xff) << 8);
}

template <int CONV, int MODE>
__global__ void __launch_bounds__(MAX_THREADS, 1)
digit_kernel(const __grid_constant__ CUtensorMap xmap0, const __grid_constant__ CUtensorMap xmap1,
             const int8_t* __restrict__ xq, const int8_t* __restrict__ wpk,
             const float* __restrict__ scale, const float* __restrict__ bias, const act::Table table,
             const float* __restrict__ bnd, int g, int8_t* __restrict__ out, const Plan p) {
  constexpr int N = CONV == 1 ? 32 : 48;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* wsm = smem + p.w_off;
  int2* tab = reinterpret_cast<int2*>(smem + p.tab_off);  // the map's table
  float* sc = reinterpret_cast<float*>(smem + p.sb_off);  // the scales, then the biases
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.bar_off);  // the S stages', the weight's
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s <= p.S; ++s) mbar_init(bars + s, 1);
    mbar_init_fence();
  }
  for (int i = tid; i < N; i += blockDim.x) {
    sc[i] = scale[i];
    sc[N + i] = bias[i];
  }
  if (MODE != BINS)
    for (int i = tid; i < table.n; i += blockDim.x) tab[i] = table.tab[i];
  __syncthreads();
  const int my_tiles = (p.n_tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;
  if (tid == 0) {
    mbar_arrive_expect_tx(bars + p.S, p.w_bytes);
    bulk_load(wsm, wpk, p.w_bytes, bars + p.S);
    for (int n = 0; n < p.S - 1 && n < my_tiles; ++n)
      issue_images<CONV>(p, &xmap0, &xmap1, xq, smem + p.stage_off + n * p.stage_bytes, bars + n,
                         blockIdx.x + n * gridDim.x);
  }
  const int wg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const uint64_t desc_w = make_desc_plain(wsm, 16 * N);
  for (int n = 0; n < my_tiles; ++n) {
    const int tile = blockIdx.x + n * gridDim.x, ahead = n + p.S - 1;
    // the stage of tile n + S - 1 was last read by tile n - 1, whose
    // products every thread finished before the barrier that ended it
    if (tid == 0 && ahead < my_tiles)
      issue_images<CONV>(p, &xmap0, &xmap1, xq, smem + p.stage_off + (ahead % p.S) * p.stage_bytes,
                         bars + ahead % p.S, blockIdx.x + ahead * gridDim.x);
    mbar_wait(bars + n % p.S, (n / p.S) & 1);
    if (n == 0) mbar_wait(bars + p.S, 0);
    const unsigned char* st = smem + p.stage_off + (n % p.S) * p.stage_bytes;
    unsigned char* ob = smem + p.out_off + (n & 1) * p.obuf_bytes;
    const int b0 = tile * p.IMG, imgs = min(p.IMG, p.B - b0);
    for (int grp = wg; grp < imgs * p.groups; grp += p.n_wg) {
      const int i = grp / p.groups;
      if (CONV == 1)
        conv1_group<MODE>(st + i * C1_IN, desc_w, grp - i * p.groups, ob + i * C1_OUT, sc, tab, table, bnd, g, wq, gq,
                          t);
      else
        conv2_image<MODE>(st + i * C2_PLANE, p.IMG * C2_PLANE, desc_w, ob + i * C2_OUT, sc, tab, table, bnd, g, wq,
                          gq, t);
    }
    fence_proxy_async();
    if (tid == 0) bulk_wait_read0();  // tile n - 1's store has read the other out buffer
    __syncthreads();
    if (tid == 0) {
      bulk_store(out + static_cast<size_t>(b0) * p.out_bytes, ob, static_cast<uint32_t>(imgs) * p.out_bytes);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait0();
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

template <int CONV, int MODE>
int launch(const CUtensorMap& map0, const CUtensorMap& map1, const void* xq, const void* wpk, const void* scale, const void* bias,
           const act::Table& table, const void* bnd, int g, void* out, const Plan& p, cudaStream_t stream) {
  auto kernel = digit_kernel<CONV, MODE>;
  const int threads = 128 * p.n_wg;
  static int smem_allowed = 48 * 1024, last_smem = -1, last_threads = -1, per_sm = 0;
  if (p.smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = p.smem;
  }
  if (p.smem != last_smem || threads != last_threads) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    last_smem = p.smem;
    last_threads = threads;
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = p.ctas < per_sm * sm_count() ? p.ctas : per_sm * sm_count();
  kernel<<<grid, threads, p.smem, stream>>>(map0, map1, static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wpk),
                                            static_cast<const float*>(scale), static_cast<const float*>(bias), table,
                                            static_cast<const float*>(bnd), g, static_cast<int8_t*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <int CONV>
int dispatch(int mode, const CUtensorMap& map0, const CUtensorMap& map1, const void* xq, const void* wpk, const void* scale, const void* bias,
             const act::Table& table, const void* bnd, int g, void* out, const Plan& p, cudaStream_t s) {
  switch (mode) {
    case POLY: return launch<CONV, POLY>(map0, map1, xq, wpk, scale, bias, table, bnd, g, out, p, s);
    case ERF: return launch<CONV, ERF>(map0, map1, xq, wpk, scale, bias, table, bnd, g, out, p, s);
    case BINS: return launch<CONV, BINS>(map0, map1, xq, wpk, scale, bias, table, bnd, g, out, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool plan_ok(const Plan& p) {
  const bool c1 = p.conv == 1;
  if ((p.conv != 1 && p.conv != 2) || p.B < 1 || p.N != (c1 ? 32 : 48) || p.IMG < 1 || p.n_wg < 1 ||
      128 * p.n_wg > MAX_THREADS || p.S < 2 || p.S > MAX_STAGES || p.n_tiles != (p.B + p.IMG - 1) / p.IMG ||
      p.ctas < 1 || p.ctas > p.n_tiles)
    return false;
  if (p.in_bytes != (c1 ? C1_IN : C2_IN) || p.out_bytes != (c1 ? C1_OUT : C2_OUT) ||
      p.w_bytes != (c1 ? C1_STEPS * C1_STEP : 25 * C2_STEP) || p.groups != (c1 ? 9 : 1) || (!c1 && p.IMG > 256))
    return false;
  return p.w_off == 0 && p.stage_off >= p.w_bytes && p.stage_off % 128 == 0 && p.stage_bytes >= p.IMG * p.in_bytes &&
         p.stage_bytes % 128 == 0 && p.out_off == p.stage_off + p.S * p.stage_bytes &&
         p.obuf_bytes >= p.IMG * p.out_bytes && p.obuf_bytes % 16 == 0 && p.tab_off >= p.out_off + 2 * p.obuf_bytes &&
         p.tab_off % 16 == 0 && p.sb_off >= p.tab_off + 8 * TABLE_ROOM && p.sb_off % 16 == 0 &&
         p.bar_off >= p.sb_off + 8 * p.N && p.bar_off % 8 == 0 && p.smem >= p.bar_off + 8 * (p.S + 1);
}

}  // namespace

extern "C" int digit_plan_ints() { return PLAN_INTS; }

// xin: conv1, the prep pass's images (B, 28, 32, 4) int8; conv2, conv1's
// pooled codes (B, 12, 12, 32) int8 (16-byte aligned); wpk the re-packed
// weight (kernels/digit.py digit_weight, 16-byte aligned), scale and bias
// (N,) f32, the relu'd map's table (modes poly and erf: its entries, (n,
// 2) int32, lo, hi, b_lo; act_codes.cuh table_code) or bnd its g f32
// boundaries (bins), out (B, Hp, Wp, N) int8 (16-byte aligned)
extern "C" int digit_launch(const void* xin, const void* wpk, const void* scale, const void* bias,
                            const void* entries, float lo, float hi, int b_lo, int n, const void* bnd, int g,
                            int mode, void* out, const int* plan, void* stream) {
  Plan p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < PLAN_INTS; ++i) dst[i] = plan[i];
  if (!plan_ok(p) || reinterpret_cast<uintptr_t>(xin) % 16 || reinterpret_cast<uintptr_t>(wpk) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || (mode != BINS && (n < 1 || n > TABLE_ROOM)))
    return static_cast<int>(cudaErrorInvalidValue);
  const act::Table table{static_cast<const int2*>(entries), lo, hi, b_lo, n};
  CUtensorMap map[2];
  memset(map, 0, sizeof(map));
  if (p.conv == 2) {  // half h: (16 bytes, 144 pixels at 32 bytes, B images at 4,608 bytes) from byte 16h
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[3] = {16, 144, static_cast<cuuint64_t>(p.B)};
    const cuuint64_t strides[2] = {32, C2_IN};
    const cuuint32_t box[3] = {16, 144, static_cast<cuuint32_t>(p.IMG)};
    const cuuint32_t elem[3] = {1, 1, 1};
    for (int h = 0; h < 2; ++h) {
      const CUresult res = encode(map + h, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                                  static_cast<char*>(const_cast<void*>(xin)) + 16 * h, dims, strides, box, elem,
                                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.conv == 1) return dispatch<1>(mode, map[0], map[1], xin, wpk, scale, bias, table, bnd, g, out, p, s);
  return dispatch<2>(mode, map[0], map[1], xin, wpk, scale, bias, table, bnd, g, out, p, s);
}
