// K1, its Hopper form: the int8 implicit-GEMM NHWC conv of qmatmul.cu for
// the ImageNet trunks' 3x3 and 1x1 convs, on wgmma with TMA-fed weight
// chunks, for sm_90a.
//
// Replaces the TPU kernel alignq_tpu/kernels/qmatmul.py:45
// int8_matmul_dequant (and XLA's int8 conv of the JAX serving graph) at the
// shapes kernels/qmatmul.py's planner gives this form; qmatmul.cu's
// mma.sync kernel keeps the others. It computes what that kernel computes,
// out[m, n] = epilogue(sum_k A[m, k] * W[n, k]) with A[m, (dy, dx, c)] =
// x[b, oy*s + dy - pad, ox*s + dx - pad, c] (zero off the image), ksize 3
// (pad 1) or 1 (pad 0), stride 1 or 2, and the same epilogue code
// (k1_epilogue.cuh). The int32 sums are exact in any order, so the two forms
// agree bit for bit in every mode.
//
// What bounds it on an H100: the trunks' 3x3 convs from 128 channels do
// 2*K*N operations per output pixel over K = 1152-4608 input bytes, far
// above the card's ridge (~590 int8 operations a byte), so the tensor
// cores' rate bounds them; their 1x1s and the 3x3s over 64 channels sit
// near or under the ridge, bound by bytes. What held qmatmul.cu back
// there: its mma.sync has half or less of wgmma's rate and takes every
// operand word by a 4-byte shared load, and where the weight does not fit
// its tiles are 32-64 output pixels, so each tile fetched the whole weight
// from L2 again.
//
// What the design does about it:
// - A CTA is n_wg warpgroups (2-4; 128 threads each); warpgroup w computes
//   rows 64w..64w+63 of a tile of TM = 64 * n_wg output rows, against an N
//   block of NB (64 or 128) columns: one wgmma.mma_async m64nNBk32
//   .s32.s8.s8 a K step, so one weight chunk in shared memory feeds TM rows.
// - Rows are the output pixels in (b, oy, ox) order, TM consecutive ones a
//   tile whatever the image's width. A 3x3 tile's input band is the run of
//   rows of the zero-padded batch (each image with its own halo rows, Hp =
//   H + 2 a image) that its pixels reach, full padded width HC = W + 2; a
//   1x1 tile's band is its TM input pixels (the strided sample at stride 2).
// - A comes from registers (the RS form): the band is read through the
//   k-word table of a 3x3 tap (koff), which no shared-memory descriptor can
//   express (a tile's rows are not at one stride). Each lane reads its 8
//   bytes of a row in one 8-byte load: the weight's K is permuted within
//   each 32-byte K step so that wgmma's A register pair (a0, a2) of lane t
//   holds k = 8t..8t+7 (see _sm90_k_order in kernels/qmatmul.py).
// - B, the weight, is K-major in shared memory, read by a descriptor. It is
//   re-packed once per weight in chunk order (each chunk's (tap, channel)
//   columns contiguous, then the K-step permutation) and a chunk comes by
//   TMA: boxes of SWZ bytes of K (128, 64 or 32: the largest that divides
//   the chunk's K) by NB rows, with the matching swizzle, so that the 8-row
//   core matrices sit at 8*SWZ bytes. The tensor map is built on the host
//   through cudaGetDriverEntryPoint (no -lcuda) by k1_sm90_weight_map, and
//   the Python wrapper keeps its bytes beside the re-packed weight.
// - K streams in chunks of CC channels (64 or 32 for a 3x3: K 576 or 288;
//   256 or 128 for a 1x1) through a ring of n_stages stage buffers (2-4,
//   as many as fit the SM's 227 KB), each the weight chunk and the
//   band of those channels. The band comes by cp.async; each thread's
//   copies and the TMA boxes complete on the stage's mbarrier (every thread
//   arrives by cp.async.mbarrier.arrive.noinc, thread 0 also by
//   arrive.expect_tx), and the warpgroups wait on it. One __syncthreads a
//   step frees the buffer that the next step's loads go into.
// - CTAs are persistent over work items (tile, N block), the N blocks of a
//   tile on neighbouring CTAs so that its band is read from L2; the loads of
//   the next n_stages - 1 steps are in flight under a tile's epilogue.
// - Within a stage the K steps alternate two A register sets: a set is
//   reloaded once wgmma.wait_group 1 shows the product that read it done.
//
// C interface: k1_sm90_launch has k1_conv_launch's operands and mode codes,
// but for the weight the bytes of its tensor map (k1_sm90_weight_map, over
// the re-packed (N8, Kp) weight); it returns cudaGetLastError()
// after the launch (or the error that refused it). The Python wrapper
// checks the operands and computes the plan (kernels/qmatmul.py sm90_plan).

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
constexpr int MAX_STAGES = 6;

// The launch plan, in the order kernels/qmatmul.py Sm90Plan lays it out.
struct Plan {
  int B, H, W, C, Ho, Wo, stride, pad, ksize, N8, Kp;
  int M, TM, n_tiles, NB, n_blocks, n_items;
  int HR, HC, Hp, P, RP;   // band rows, cols, padded rows an image; smem pixel and row pitch
  int CC, n_chunks, KC, KCL;  // channels a chunk; chunks; K bytes of a chunk, of the last
  int SWZ, n_boxes, w_bytes, a_bytes, stage_bytes, n_stages, koff_words, smem, n_wg;
};
constexpr int PLAN_INTS = sizeof(Plan) / sizeof(int);

// ------------------------------------------------------------ copies

// one arrival once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// cp.async of 16 bytes; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

// ------------------------------------------------------------ the tiles

// Row of the zero-padded batch (Hp rows an image) that output pixel m's top
// tap row reads, and its column ox
__device__ __forceinline__ int band_row(const Plan& p, int m, int& ox) {
  const int hw = p.Ho * p.Wo;
  const int b = m / hw, r = m - b * hw, oy = r / p.Wo;
  ox = r - oy * p.Wo;
  return b * p.Hp + oy * p.stride;
}

// Issue the loads of step (item, chunk) into stage buffer st: the weight
// chunk's TMA boxes (thread 0) and the band of the chunk's channels
// [c0, c0 + CC) (every thread, then its arrival on bar).
template <int KS>
__device__ void issue_step(const Plan& p, const int8_t* __restrict__ x, const CUtensorMap* wmap,
                           unsigned char* st, uint64_t* bar, int item, int chunk) {
  const int tile = item / p.n_blocks, nb = item - tile * p.n_blocks;
  const int m0 = tile * p.TM;
  const int c0 = chunk * p.CC;
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, p.w_bytes);
    const int k0 = KS * KS * c0;  // the chunk's first column of the re-packed weight
    for (int a = 0; a < p.n_boxes; ++a)
      tma_load_2d(st + a * p.NB * p.SWZ, wmap, bar, k0 + a * p.SWZ, nb * p.NB);
  }
  unsigned char* band = st + p.w_bytes;
  const int nv = min(p.CC, p.C - c0) >> 4;  // 16-byte copies a pixel
  if (KS == 1) {
    const int rows = min(p.TM, p.M - m0);
    for (int i = threadIdx.x; i < rows * nv; i += blockDim.x) {
      const int r = i / nv, v = i - r * nv;
      size_t pix = m0 + r;
      if (p.stride != 1) {
        int ox;
        const int gr = band_row(p, m0 + r, ox), b = gr / p.Hp;
        pix = (static_cast<size_t>(b) * p.H + (gr - b * p.Hp)) * p.W + ox * p.stride;
      }
      cp_async16(band + r * p.P + v * 16, x + pix * p.C + c0 + v * 16, 16);
    }
  } else {
    int ox;
    const int r0 = band_row(p, m0, ox);
    const int rows = band_row(p, min(m0 + p.TM, p.M) - 1, ox) - r0 + KS;
    const int row_items = p.HC * nv;
    for (int i = threadIdx.x; i < rows * row_items; i += blockDim.x) {
      const int r = i / row_items, rem = i - r * row_items, cx = rem / nv, v = rem - cx * nv;
      const int gr = r0 + r, b = gr / p.Hp, iy = gr - b * p.Hp - p.pad, ix = cx - p.pad;
      const bool in = static_cast<unsigned>(iy) < static_cast<unsigned>(p.H) &&
                      static_cast<unsigned>(ix) < static_cast<unsigned>(p.W);
      const int8_t* src = in ? x + ((static_cast<size_t>(b) * p.H + iy) * p.W + ix) * p.C + c0 + v * 16 : x;
      cp_async16(band + r * p.RP + cx * p.P + v * 16, src, in ? 16 : 0);
    }
  }
  cp_async_arrive(bar);
}

// Rows g and g + 8 of this warp's 16 in a 16 x 32 A fragment: lane t's 8
// bytes of each at the band offset `off` (k = 8t..8t+7 of the K step)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const unsigned char* band, int base0, int base1,
                                       int off) {
  const uint2 lo = *reinterpret_cast<const uint2*>(band + base0 + off);
  const uint2 hi = *reinterpret_cast<const uint2*>(band + base1 + off);
  a[0] = lo.x;
  a[2] = lo.y;
  a[1] = hi.x;
  a[3] = hi.y;
}

template <int MODE, int KS, int NB>
__global__ void __launch_bounds__(MAX_THREADS, 1)
k1_sm90_kernel(const int8_t* __restrict__ x, const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ scale, const float* __restrict__ bias, void* __restrict__ out,
               const Plan p, const ActArgs act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the stage buffers at a 1024-byte boundary (the swizzle's period)
  unsigned char* stages = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + p.n_stages * p.stage_bytes);
  int* koff = reinterpret_cast<int*>(full + MAX_STAGES);  // KS 3: band offset of each (K step, lane t)

  const int tid = threadIdx.x;
  const int S = p.n_stages;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + s, blockDim.x + 1);
    mbar_init_fence();
  }
  if (KS > 1) {
    // entry q: k = 8q of a chunk, tap k / CC, channel k % CC (a K step of
    // 32 lies in one tap: CC % 32 == 0)
    for (int q = tid; q < p.koff_words; q += blockDim.x) {
      const int k = 8 * q, tap = k / p.CC, c = k - tap * p.CC;
      koff[q] = (tap / KS) * p.RP + (tap % KS) * p.P + c;
    }
  }
  __syncthreads();

  const int my_items = (p.n_items - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;
  const int n_steps = my_items * p.n_chunks;
  for (int s = 0; s < S - 1 && s < n_steps; ++s)
    issue_step<KS>(p, x, &wmap, stages + s * p.stage_bytes, full + s, blockIdx.x + (s / p.n_chunks) * gridDim.x,
                   s % p.n_chunks);

  const int wg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 64 * wg + 16 * wq + g;  // this thread's tile rows row0 and row0 + 8
  const int swz_log2 = __ffs(p.SWZ) - 1;
  int acc[NB / 2];
  int base0 = 0, base1 = 0, m_0 = 0, m_1 = 0;

  for (int s = 0; s < n_steps; ++s) {
    if (s > 0) __syncthreads();  // every thread is done with the buffer of step s - 1
    const int s1 = s + S - 1;
    if (s1 < n_steps)
      issue_step<KS>(p, x, &wmap, stages + (s1 % S) * p.stage_bytes, full + s1 % S,
                     blockIdx.x + (s1 / p.n_chunks) * gridDim.x, s1 % p.n_chunks);
    const int item = blockIdx.x + (s / p.n_chunks) * gridDim.x, chunk = s % p.n_chunks;
    const int tile = item / p.n_blocks, nb = item - tile * p.n_blocks;
    const int m0 = tile * p.TM;
    if (chunk == 0) {
      m_0 = m0 + row0;
      m_1 = m_0 + 8;
      if (KS == 1) {
        base0 = row0 * p.P;
        base1 = base0 + 8 * p.P;
      } else {
        // rows past M read the last row's band (their sums are not stored)
        int ox;
        const int r0 = band_row(p, m0, ox);
        const int g0 = band_row(p, min(m_0, p.M - 1), ox);
        base0 = (g0 - r0) * p.RP + ox * p.stride * p.P;
        const int g1 = band_row(p, min(m_1, p.M - 1), ox);
        base1 = (g1 - r0) * p.RP + ox * p.stride * p.P;
      }
    }
    unsigned char* st = stages + (s % S) * p.stage_bytes;
    const unsigned char* band = st + p.w_bytes;
    const uint64_t desc0 = make_desc(st, p.SWZ);
    const bool last = chunk == p.n_chunks - 1;
    const int nk = (last ? p.KCL : p.KC) >> 5;
    mbar_wait(full + s % S, (s / S) & 1);

#pragma unroll
    for (int i = 0; i < NB / 2; ++i) reg_fence(acc[i]);
    uint32_t a0[4], a1[4];
    for (int ks = 0; ks < nk; ks += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = ks + h;
        if (h == 1 && k >= nk) break;
        uint32_t(&a)[4] = h == 0 ? a0 : a1;
        const int off = KS > 1 ? koff[4 * k + t] : 32 * k + 8 * t;
        load_a(a, band, base0, base1, off);
        const int kb = 32 * k;
        const uint64_t desc = desc0 + ((((kb >> swz_log2) * NB * p.SWZ) + (kb & (p.SWZ - 1))) >> 4);
        wgmma_fence();
        wgmma_rs<NB>(acc, a, desc, chunk > 0 || k > 0);
        wgmma_commit();
        // the product before this one is done: its A set may be reloaded
        wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < 4; ++i) reg_fence(h == 0 ? a1[i] : a0[i]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) reg_fence(acc[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      reg_fence(a0[i]);
      reg_fence(a1[i]);
    }
    if (!last) continue;

    // accumulator 4j + 2h + v: tile row row0 + 8h, column 8j + 2t + v
    const int n0 = nb * p.NB;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      float s0 = 0.f, s1v = 0.f, c0 = 0.f, c1 = 0.f;
      if (MODE != INT32 && MODE != BINS_INT) {
        s0 = scale[col], s1v = scale[col + 1], c0 = bias[col], c1 = bias[col + 1];
      }
      if (m_0 < p.M) store2<MODE>(out, m_0, col, p.N8, acc[4 * j], acc[4 * j + 1], s0, s1v, c0, c1, act);
      if (m_1 < p.M) store2<MODE>(out, m_1, col, p.N8, acc[4 * j + 2], acc[4 * j + 3], s0, s1v, c0, c1, act);
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

template <int MODE, int KS, int NB>
int launch(const void* x, const CUtensorMap& map, const void* scale, const void* bias, void* out, const Plan& p,
           const ActArgs& a, cudaStream_t stream) {
  auto kernel = k1_sm90_kernel<MODE, KS, NB>;
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
  const int slots = per_sm * sm_count();
  kernel<<<p.n_items < slots ? p.n_items : slots, threads, p.smem, stream>>>(
      static_cast<const int8_t*>(x), map, static_cast<const float*>(scale), static_cast<const float*>(bias), out, p,
      a);
  return static_cast<int>(cudaGetLastError());
}

template <int KS, int NB>
int dispatch(int mode, const void* x, const CUtensorMap& map, const void* scale, const void* bias, void* out,
             const Plan& p, const ActArgs& a, cudaStream_t s) {
  switch (mode) {
    case INT32: return launch<INT32, KS, NB>(x, map, scale, bias, out, p, a, s);
    case F32: return launch<F32, KS, NB>(x, map, scale, bias, out, p, a, s);
    case RELU: return launch<RELU, KS, NB>(x, map, scale, bias, out, p, a, s);
    case POLY: return launch<POLY, KS, NB>(x, map, scale, bias, out, p, a, s);
    case ERF: return launch<ERF, KS, NB>(x, map, scale, bias, out, p, a, s);
    case BINS: return launch<BINS, KS, NB>(x, map, scale, bias, out, p, a, s);
    case BINS_INT: return launch<BINS_INT, KS, NB>(x, map, scale, bias, out, p, a, s);
    case REQUANT: return launch<REQUANT, KS, NB>(x, map, scale, bias, out, p, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int k1_sm90_plan_ints() { return PLAN_INTS; }

extern "C" int k1_sm90_map_bytes() { return static_cast<int>(sizeof(CUtensorMap)); }

// The tensor map of a re-packed weight wt (N8, Kp) int8 in boxes of swz
// bytes of K by nb rows, with the matching swizzle, into map_out (host
// memory of k1_sm90_map_bytes()) for k1_sm90_launch: the caller keeps it
// beside the re-packed weight, for as long as that lives.
extern "C" int k1_sm90_weight_map(const void* wt, int kp, int n8, int swz, int nb, void* map_out) {
  if ((swz != 128 && swz != 64 && swz != 32) || (nb != 64 && nb != 128) || kp % swz || n8 % nb)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(n8)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp)};
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

extern "C" int k1_sm90_launch(const void* x, const void* wmap, const void* scale, const void* bias, void* out,
                              const int* plan, int mode, const void* bnd, const void* sgn, const void* t1,
                              const void* t2, int g, int relu, void* stream) {
  Plan p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < PLAN_INTS; ++i) dst[i] = plan[i];
  if (p.n_wg < 1 || 128 * p.n_wg > MAX_THREADS || p.n_stages < 2 || p.n_stages > MAX_STAGES || p.TM != 64 * p.n_wg ||
      p.n_items < 1 || p.CC % 32 || (p.SWZ != 128 && p.SWZ != 64 && p.SWZ != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  memcpy(&map, wmap, sizeof(map));
  const ActArgs a{static_cast<const float*>(bnd), static_cast<const int*>(sgn), static_cast<const int*>(t1),
                  static_cast<const int*>(t2), g, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.ksize == 3 && p.NB == 128) return dispatch<3, 128>(mode, x, map, scale, bias, out, p, a, s);
  if (p.ksize == 3 && p.NB == 64) return dispatch<3, 64>(mode, x, map, scale, bias, out, p, a, s);
  if (p.ksize == 1 && p.NB == 128) return dispatch<1, 128>(mode, x, map, scale, bias, out, p, a, s);
  if (p.ksize == 1 && p.NB == 64) return dispatch<1, 64>(mode, x, map, scale, bias, out, p, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
