// K1, its narrow Hopper form: the int8 implicit-GEMM NHWC conv of
// qmatmul.cu for the narrow 3x3 and 1x1 convs, on wgmma m64nNk32 with N
// the conv's own width (16, 32 or 64 columns an N block), for sm_90a.
//
// Replaces the TPU kernel alignq_tpu/kernels/qmatmul.py:45
// int8_matmul_dequant (and XLA's int8 conv of the JAX serving graph,
// alignq_tpu/kernels/infer.py _int8_conv_acc, infer_densenet.py) at the
// shapes kernels/qmatmul.py's planner gives this form: the 3x3 (pad 1,
// stride 1) and 1x1 (pad 0, stride 1 or 2) convs over C % 16 == 0 channels
// that qmatmul_sm90.cu does not take (C % 32 or N8 % 64): ResNet-20's
// stage-1 conv and block-3 skip and conv1, DenseNet-40's growth convs and
// transitions, MobileNet-V2's narrow 1x1s. It computes what qmatmul.cu's k1_conv_kernel computes, out[m, n] =
// epilogue(sum_k A[m, k] * W[n, k]) with A[m, (dy, dx, c)] =
// x[b, oy*s + dy - pad, ox*s + dx - pad, c], through the same epilogue code
// (k1_epilogue.cuh); the int32 sums are exact in any order, so the
// forms agree bit for bit in every mode.
//
// What bounds it on an H100: bytes. At N = 16-32 a 3x3 conv does 2*9*C*N
// operations a pixel against C input and N output bytes: 290-580 int8
// operations a byte at ResNet-20's shapes, under the card's ridge (~590);
// DenseNet-40's growth convs (C up to 448 to N = 12) sit at ~220. What held
// qmatmul.cu back there (k1_split.py, PERF.md): its products and fragment
// loads (a third to a half of its time), one tile at a time a CTA with a
// sync a step, and at DenseNet's 8x8 maps too few tiles to hide a K of
// 4,032. A first form of this kernel with wgmma's A from registers (8-byte
// loads a lane through a k-word table) spent as much on its products: at
// N = 16 each wgmma takes 2 KB of A for 16 columns of sums. Here A comes
// from shared memory by a descriptor, and the epilogue, which at these
// widths costs as much as the products, runs on every thread of the CTA.
//
// What the design does about it:
// - A by descriptor: the band lies in shared memory group-major, each 16
//   channels of a chunk (a group) a run of pixels 16 bytes apart, so that
//   8 pixels in a row are one of wgmma's core matrices (no swizzle; the
//   next 8 rows 128 bytes on). A 3x3 conv (stride 1) runs over the rows of
//   the zero-padded batch (Hp = H + 2 rows of HC = W + 2 pixels an image),
//   each output row r at padded position p = m0 + r: tap (dy, dx) of row r
//   is band pixel r + dy * HC + dx, one stride for the whole m64 group,
//   and the halo's positions are computed and dropped (1.13x the rows at
//   32x32, 1.56x at 8x8). A 1x1 (stride 1 or 2) runs over the output
//   pixels; its band is the sample they read.
// - A K step (32 bytes) is two groups of one tap (the descriptor's second
//   16 bytes one group on), or, for the odd group of a chunk, one group of
//   two taps (the second tap's offset on); the weight's K is re-packed in
//   that order once (kernels/qmatmul.py _narrow_k_order), the odd group's
//   last tap paired with zero columns. A table of each step's A offset and
//   second-half offset is built per CTA.
// - The whole weight of the CTA's N block (NB rows of the re-packed K) is
//   resident in shared memory, brought by TMA once a CTA in boxes of SWZ
//   bytes of K by NB rows under the matching swizzle (at N8 = 16 even
//   DenseNet's deepest weight is 63 KB). Only the band streams, through a
//   ring of n_stages buffers of CC channels each (cp.async 16 bytes a copy,
//   completing on the stage's mbarrier), so the loads of the next steps are
//   in flight under a tile's products and epilogue.
// - A CTA is n_wg = WM * WK warpgroups: WM over the tile's rows, WK over
//   its K steps (step i of a tile to warpgroup i % WK). Each warpgroup holds
//   MG m64 row groups (MG * NB / 2 int32 accumulators a thread; MG is 1, or
//   64 / NB, a template parameter, so that MG = 1 leaves the registers for
//   more CTAs an SM), so a tile is TM = 64 * MG * WM rows: at N = 16 a
//   warpgroup keeps up to 256 rows. Where WK > 1 (small M, deep K), each
//   K share's sums are added in the epilogue; the sums are exact in any
//   order.
// - The epilogue runs on every thread of the CTA, whatever its warpgroups'
//   roles: the sums go to an int32 tile in shared memory, then each thread
//   takes 16 columns of a row, maps them by the shared code (site_code,
//   word_value) and stores them in 16-byte stores (8 where a row of codes
//   is not a multiple of 16 bytes), never 2 bytes a lane; the halo's rows
//   are dropped.
// - CTAs are persistent over work items (tile, N block); the grid is a
//   multiple of the N blocks, so each CTA keeps one N block's weight.
//
// C interface: k1_narrow_launch has k1_sm90_launch's operands and mode
// codes, the tensor map of the weight re-packed for this form
// (k1_narrow_weight_map, over (n_blocks * NB, KT) int8); it returns
// cudaGetLastError() after the launch (or the error that refused it). The
// Python wrapper checks the operands and computes the plan
// (kernels/qmatmul.py narrow_plan).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <string.h>

#include "k1_epilogue.cuh"
#include "sm90_common.cuh"

namespace {

using k1::ActArgs;
using namespace k1;  // the epilogue modes
using namespace sm90;

constexpr int MAX_THREADS = 512;
constexpr int MAX_STAGES = 4;

// The launch plan, in the order kernels/qmatmul.py NarrowPlan lays it out.
// Offsets of the shared-memory regions are from the 1024-byte aligned base
// where the weight lies.
struct Plan {
  int B, H, W, C, Ho, Wo, stride, pad, ksize, N8, Kp;
  int M, MP, TM, n_tiles, NB, n_blocks, n_items;  // MP: the rows run (M, or the padded batch's for a 3x3)
  int MG, WM, WK, n_wg;         // row groups a warpgroup; warpgroups over rows, over K
  int Hp, HC, NPIX, GS;         // padded rows an image and pixels a row; band pixels and bytes a group
  int CC, G, n_chunks, KCP, KT;  // channels, groups a chunk; chunks; K bytes of a chunk, of the weight
  int SWZ, n_boxes, w_bytes;     // the weight's TMA boxes
  int a_bytes, stage_bytes, n_stages, steps;
  int stage_off, acc_off, sb_off, tab_off, bar_off, smem;
};
constexpr int PLAN_INTS = sizeof(Plan) / sizeof(int);

// one arrival once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// cp.async of 16 bytes; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

// Issue the band of step (item, chunk) into stage buffer band: group q of
// band pixel i at q * GS + 16 i, the chunk's channels [c0, c0 + CC) (every
// thread, then its arrival on bar). A 3x3's band pixel i is padded position
// m0 + i (zero in the halo and past the batch); a 1x1's, output pixel m0 + i's
// input pixel.
__device__ void issue_step(const Plan& p, const int8_t* __restrict__ x, unsigned char* band, uint64_t* bar,
                           int item, int chunk) {
  const int m0 = (item / p.n_blocks) * p.TM;
  const int c0 = chunk * p.CC;
  const int per_image = p.Hp * p.HC;
  for (int i = threadIdx.x; i < p.NPIX * p.G; i += blockDim.x) {
    const int pix = i / p.G, q = i - pix * p.G;
    const int pos = m0 + pix;
    const int8_t* src = x;
    bool in;
    if (p.ksize == 1) {
      in = pos < p.M;
      if (in) {
        const int hw = p.Ho * p.Wo, b = pos / hw, r = pos - b * hw, oy = r / p.Wo, ox = r - oy * p.Wo;
        src = x + ((static_cast<size_t>(b) * p.H + oy * p.stride) * p.W + ox * p.stride) * p.C + c0 + 16 * q;
      }
    } else {
      const int b = pos / per_image, rem = pos - b * per_image, py = rem / p.HC, px = rem - py * p.HC;
      const int iy = py - 1, ix = px - 1;
      in = b < p.B && static_cast<unsigned>(iy) < static_cast<unsigned>(p.H) &&
           static_cast<unsigned>(ix) < static_cast<unsigned>(p.W);
      if (in) src = x + ((static_cast<size_t>(b) * p.H + iy) * p.W + ix) * p.C + c0 + 16 * q;
    }
    cp_async16(band + q * p.GS + 16 * pix, src, in ? 16 : 0);
  }
  cp_async_arrive(bar);
}

// Band pixel offset of tap t from an output row's own pixel
__device__ __forceinline__ int tap_off(const Plan& p, int t) {
  return p.ksize == 1 ? 0 : (t / 3) * p.HC + (t % 3);
}

// The output row of the tile's row r (padded position m0 + r for a 3x3),
// or -1 for the halo's rows and past the end
__device__ __forceinline__ int out_row(const Plan& p, int m0, int r) {
  const int pos = m0 + r;
  if (pos >= p.MP) return -1;
  if (p.ksize == 1) return pos;
  const int per_image = p.Hp * p.HC;
  const int b = pos / per_image, rem = pos - b * per_image, oy = rem / p.HC, ox = rem - oy * p.HC;
  return oy < p.H && ox < p.W ? (b * p.H + oy) * p.W + ox : -1;
}

// the int32 staging tile's row pitch in words: 8 over the N block, so
// that the 8 rows a warp's accumulator store touches fall on distinct banks
template <int NB>
__host__ __device__ constexpr int acc_pitch() {
  return NB + 8;
}

template <int MODE, int NB, int MG>
__global__ void __launch_bounds__(MAX_THREADS, 1)
k1_narrow_kernel(const int8_t* __restrict__ x, const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ scale, const float* __restrict__ bias, void* __restrict__ out,
                 const Plan p, const ActArgs act) {
  constexpr int SP = acc_pitch<NB>();
  constexpr bool CODES = MODE >= POLY;  // int8 outputs (the codes and requant), else 4-byte ones
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the weight at a 1024-byte boundary (the swizzle's period), the other
  // regions at the plan's offsets from it
  unsigned char* wsm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* stages = wsm + p.stage_off;
  int* accs = reinterpret_cast<int*>(wsm + p.acc_off);  // WK int32 tiles (TM, SP): each K share's sums
  float* sc = reinterpret_cast<float*>(wsm + p.sb_off);  // the N block's scales, then its biases
  int2* tab = reinterpret_cast<int2*>(wsm + p.tab_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + p.bar_off);
  uint64_t* wbar = full + MAX_STAGES;

  const int tid = threadIdx.x;
  const int S = p.n_stages;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + s, blockDim.x);
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  // step k of a chunk: (A's offset in the band, its second 16 bytes' offset
  // from the first): the group pairs tap after tap, then the odd group's
  // taps two at a time (its last tap against zero weights)
  const int taps = p.ksize * p.ksize, pairs = (p.G / 2) * taps;
  for (int k = tid; k < p.steps; k += blockDim.x) {
    if (k < pairs) {
      const int j = k / taps, t = k - j * taps;
      tab[k] = make_int2(2 * j * p.GS + 16 * tap_off(p, t), p.GS);
    } else {
      const int t = 2 * (k - pairs);
      tab[k] = make_int2((p.G - 1) * p.GS + 16 * tap_off(p, t),
                         t + 1 < taps ? 16 * (tap_off(p, t + 1) - tap_off(p, t)) : 16);
    }
  }
  __syncthreads();
  // the CTA's N block: the grid is a multiple of n_blocks
  const int nb = static_cast<int>(blockIdx.x) % p.n_blocks;
  const int n0 = nb * NB;
  for (int i = tid; i < NB; i += blockDim.x) {
    const bool in = n0 + i < p.N8;
    sc[i] = in ? scale[n0 + i] : 0.f;
    sc[NB + i] = in ? bias[n0 + i] : 0.f;
  }
  if (tid == 0) {
    mbar_arrive_expect_tx(wbar, p.w_bytes);
    for (int a = 0; a < p.n_boxes; ++a) tma_load_2d(wsm + a * NB * p.SWZ, &wmap, wbar, a * p.SWZ, nb * NB);
  }

  const int my_items = (p.n_items - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;
  const int n_steps = my_items * p.n_chunks;
  for (int s = 0; s < S - 1 && s < n_steps; ++s)
    issue_step(p, x, stages + s * p.stage_bytes, full + s, blockIdx.x + (s / p.n_chunks) * gridDim.x,
               s % p.n_chunks);

  const int wg = tid >> 7, wm = wg % p.WM, wk = wg / p.WM;
  const int rt = tid & 127, wq = rt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int swz_log2 = __ffs(p.SWZ) - 1;
  const int nk = p.steps;  // K steps a chunk
  const uint64_t desc_w = make_desc(wsm, p.SWZ);
  int acc[MG][NB / 2];
  int started = 0;  // this warpgroup's products of the tile so far: the first starts the sums

  for (int s = 0; s < n_steps; ++s) {
    if (s > 0) __syncthreads();  // every thread is done with the buffer of step s - 1 and the int32 tiles
    const int s1 = s + S - 1;
    if (s1 < n_steps)
      issue_step(p, x, stages + (s1 % S) * p.stage_bytes, full + s1 % S, blockIdx.x + (s1 / p.n_chunks) * gridDim.x,
                 s1 % p.n_chunks);
    const int item = blockIdx.x + (s / p.n_chunks) * gridDim.x, chunk = s % p.n_chunks;
    const int m0 = (item / p.n_blocks) * p.TM;
    if (chunk == 0) started = 0;
    // A of this warpgroup's row group 0 (each next group 64 rows, 1 KB, on)
    const uint64_t desc_a = make_desc_plain(stages + (s % S) * p.stage_bytes + 1024 * MG * wm, 0);
    mbar_wait(full + s % S, (s / S) & 1);
    if (s == 0) mbar_wait(wbar, 0);

#pragma unroll
    for (int mg = 0; mg < MG; ++mg)
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) reg_fence(acc[mg][i]);
    // this warpgroup's first K step of the chunk: the tile's step
    // chunk * nk + k goes to warpgroup (chunk * nk + k) % WK
    for (int k = ((wk - chunk * nk) % p.WK + p.WK) % p.WK; k < nk; k += p.WK) {
      const int2 e = tab[k];
      const int kb = chunk * p.KCP + 32 * k;  // the step's first column of the resident weight
      const uint64_t db = desc_w + ((((kb >> swz_log2) * NB * p.SWZ) + (kb & (p.SWZ - 1))) >> 4);
      const uint64_t da = desc_a + (static_cast<uint64_t>(e.y >> 4) << 16) + (e.x >> 4);
      wgmma_fence();
#pragma unroll
      for (int mg = 0; mg < MG; ++mg) wgmma_ss<NB>(acc[mg], da + 64 * mg, db, started);
      started = 1;
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mg = 0; mg < MG; ++mg)
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) reg_fence(acc[mg][i]);
    if (chunk != p.n_chunks - 1) continue;

    // each warpgroup's sums into its K share's int32 tile: accumulator
    // 4j + 2h + v of group mg is tile row 64 (MG wm + mg) + 16 wq + g + 8h,
    // column 8j + 2t + v
    int* mine = accs + wk * p.TM * SP;
#pragma unroll
    for (int mg = 0; mg < MG; ++mg)
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * (MG * wm + mg) + 16 * wq + g + 8 * h;
          *reinterpret_cast<int2*>(mine + r * SP + 8 * j + 2 * t) = make_int2(acc[mg][4 * j + 2 * h],
                                                                             acc[mg][4 * j + 2 * h + 1]);
        }
    __syncthreads();
    // the epilogue on every thread of the CTA: 16 columns of a row a turn,
    // the K shares summed, mapped by the shared code (site_code,
    // word_value) and stored in 16-byte stores (8 where a row of codes is
    // not a multiple of 16 bytes); the halo's rows dropped
    constexpr int CPR = NB / 16;  // 16-column pieces a row
    for (int i = tid; i < p.TM * CPR; i += blockDim.x) {
      const int r = i / CPR, c = 16 * (i - r * CPR), col = n0 + c, m = out_row(p, m0, r);
      if (m < 0 || col >= p.N8) continue;
      int v[16];
#pragma unroll
      for (int k = 0; k < 16; k += 4) *reinterpret_cast<int4*>(v + k) = *reinterpret_cast<const int4*>(accs + r * SP + c + k);
      for (int w = 1; w < p.WK; ++w) {
        const int* theirs = accs + (w * p.TM + r) * SP + c;
#pragma unroll
        for (int k = 0; k < 16; k += 4) {
          const int4 u = *reinterpret_cast<const int4*>(theirs + k);
          v[k] += u.x, v[k + 1] += u.y, v[k + 2] += u.z, v[k + 3] += u.w;
        }
      }
      const bool half = col + 8 >= p.N8;  // the last 8 columns of the output: store the first half only
      if constexpr (CODES) {
        uint32_t q[4];
#pragma unroll
        for (int k = 0; k < 16; k += 4) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            word |= (static_cast<uint32_t>(site_code<MODE>(v[k + e], sc[c + k + e], sc[NB + c + k + e], col + k + e,
                                                           act, p.N8)) & 0xff) << (8 * e);
          q[k / 4] = word;
        }
        int8_t* dst = static_cast<int8_t*>(out) + static_cast<size_t>(m) * p.N8 + col;
        if (p.N8 % 16 == 0 && !half) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
        } else {
          *reinterpret_cast<uint2*>(dst) = make_uint2(q[0], q[1]);
          if (!half) *reinterpret_cast<uint2*>(dst + 8) = make_uint2(q[2], q[3]);
        }
      } else {
        uint32_t* dst = static_cast<uint32_t*>(out) + static_cast<size_t>(m) * p.N8 + col;
#pragma unroll
        for (int k = 0; k < 16; k += 4) {
          if (half && k >= 8) break;
          *reinterpret_cast<uint4*>(dst + k) =
              make_uint4(word_value<MODE>(v[k], sc[c + k], sc[NB + c + k]),
                         word_value<MODE>(v[k + 1], sc[c + k + 1], sc[NB + c + k + 1]),
                         word_value<MODE>(v[k + 2], sc[c + k + 2], sc[NB + c + k + 2]),
                         word_value<MODE>(v[k + 3], sc[c + k + 3], sc[NB + c + k + 3]));
        }
      }
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

template <int MODE, int NB, int MG>
int launch(const void* x, const CUtensorMap& map, const void* scale, const void* bias, void* out, const Plan& p,
           const ActArgs& a, cudaStream_t stream) {
  auto kernel = k1_narrow_kernel<MODE, NB, MG>;
  const int threads = 128 * p.n_wg;
  // the attribute and the occupancy of this instance's last shared-memory size
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
  // persistent CTAs: those the SMs hold, a multiple of the N blocks (each
  // CTA then keeps one block's weight)
  int grid = per_sm * sm_count() / p.n_blocks * p.n_blocks;
  if (grid < p.n_blocks) grid = p.n_blocks;
  if (grid > p.n_items) grid = p.n_items;
  kernel<<<grid, threads, p.smem, stream>>>(static_cast<const int8_t*>(x), map, static_cast<const float*>(scale),
                                            static_cast<const float*>(bias), out, p, a);
  return static_cast<int>(cudaGetLastError());
}

template <int NB, int MG>
int dispatch(int mode, const void* x, const CUtensorMap& map, const void* scale, const void* bias, void* out,
             const Plan& p, const ActArgs& a, cudaStream_t s) {
  switch (mode) {
    case INT32: return launch<INT32, NB, MG>(x, map, scale, bias, out, p, a, s);
    case F32: return launch<F32, NB, MG>(x, map, scale, bias, out, p, a, s);
    case RELU: return launch<RELU, NB, MG>(x, map, scale, bias, out, p, a, s);
    case POLY: return launch<POLY, NB, MG>(x, map, scale, bias, out, p, a, s);
    case ERF: return launch<ERF, NB, MG>(x, map, scale, bias, out, p, a, s);
    case BINS: return launch<BINS, NB, MG>(x, map, scale, bias, out, p, a, s);
    case BINS_INT: return launch<BINS_INT, NB, MG>(x, map, scale, bias, out, p, a, s);
    case REQUANT: return launch<REQUANT, NB, MG>(x, map, scale, bias, out, p, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int k1_narrow_plan_ints() { return PLAN_INTS; }

extern "C" int k1_narrow_map_bytes() { return static_cast<int>(sizeof(CUtensorMap)); }

// The tensor map of a re-packed weight wt (n8p, kt) int8 in boxes of swz
// bytes of K by nb rows, with the matching swizzle, into map_out (host
// memory of k1_narrow_map_bytes()) for k1_narrow_launch: the caller keeps
// it beside the re-packed weight, for as long as that lives.
extern "C" int k1_narrow_weight_map(const void* wt, int kt, int n8p, int swz, int nb, void* map_out) {
  if ((swz != 128 && swz != 64 && swz != 32) || (nb != 16 && nb != 32 && nb != 64) || kt % swz || n8p % nb)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kt), static_cast<cuuint64_t>(n8p)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kt)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(swz), static_cast<cuuint32_t>(nb)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle mode = swz == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : swz == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap map;
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wt), dims, strides, box,
                              elem, CU_TENSOR_MAP_INTERLEAVE_NONE, mode, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  memcpy(map_out, &map, sizeof(map));
  return 0;
}

extern "C" int k1_narrow_launch(const void* x, const void* wmap, const void* scale, const void* bias, void* out,
                                const int* plan, int mode, const void* bnd, const void* sgn, const void* t1,
                                const void* t2, int g, int relu, void* stream) {
  Plan p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < PLAN_INTS; ++i) dst[i] = plan[i];
  if (p.n_wg != p.WM * p.WK || p.n_wg < 1 || 128 * p.n_wg > MAX_THREADS ||
      p.TM != 64 * p.MG * p.WM || p.n_stages < 2 || p.n_stages > MAX_STAGES || p.n_items < 1 || p.CC != 16 * p.G ||
      p.KCP != 32 * p.steps || p.n_chunks * p.steps < p.WK || (p.SWZ != 128 && p.SWZ != 64 && p.SWZ != 32) ||
      (p.ksize == 3 && p.stride != 1) || p.bar_off % 8 || p.stage_off % 16 || p.stage_bytes % 16 ||
      p.GS % 16 || p.acc_off % 16 || p.sb_off % 16 || p.tab_off % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  memcpy(&map, wmap, sizeof(map));
  const ActArgs a{static_cast<const float*>(bnd), static_cast<const int*>(sgn), static_cast<const int*>(t1),
                  static_cast<const int*>(t2), g, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // row groups a warpgroup: 1, or as many as keep 32 accumulators a thread
  if (p.NB == 16 && p.MG == 1) return dispatch<16, 1>(mode, x, map, scale, bias, out, p, a, s);
  if (p.NB == 16 && p.MG == 4) return dispatch<16, 4>(mode, x, map, scale, bias, out, p, a, s);
  if (p.NB == 32 && p.MG == 1) return dispatch<32, 1>(mode, x, map, scale, bias, out, p, a, s);
  if (p.NB == 32 && p.MG == 2) return dispatch<32, 2>(mode, x, map, scale, bias, out, p, a, s);
  if (p.NB == 64 && p.MG == 1) return dispatch<64, 1>(mode, x, map, scale, bias, out, p, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
