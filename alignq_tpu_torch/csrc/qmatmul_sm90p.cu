// K1, its plane form: the int8 implicit-GEMM NHWC 3x3 conv (pad 1, stride
// 1 or 2) over 16 or 32 channels on wgmma m64nNk32 with A and B by
// descriptors, each image's whole plane in shared memory, for sm_90a.
//
// Replaces the TPU kernel alignq_tpu/kernels/qmatmul.py:45
// int8_matmul_dequant (and XLA's int8 conv of the JAX serving graph,
// alignq_tpu/kernels/infer.py _int8_conv_acc) at the shapes
// kernels/qmatmul.py's planner gives this form (plane_plan, plane_takes):
// ResNet-20's and ResNet-56's 16x16 stage, the stride-2 conv0 from
// 32x32x16 to 32 channels and the 3x3s from 32 to 32 channels, which
// neither other Hopper form took (qmatmul_sm90.cu needs C % 32 and N8 %
// 64; qmatmul_sm90n.cu took no stride-2 3x3 and lost the stride-1 ones to
// qmatmul.cu). It computes what qmatmul.cu's k1_conv_kernel computes,
// out[m, n] = epilogue(sum_k A[m, k] * W[n, k]), A[m, (dy, dx, c)] =
// x[b, oy*s + dy - 1, ox*s + dx - 1, c], through the same epilogue code
// (k1_epilogue.cuh; the erf and poly codes through their step tables,
// site_codes4); the int32 sums are exact in any order, so the forms agree
// bit for bit in every mode.
//
// What bounds it on an H100: bytes. The convs do 2 * 9 * C * N int8
// operations an output pixel against ~C (stride 1) or 4C (stride 2) input
// and N output bytes: ~290-580 operations a byte, under the card's ridge.
// What held the earlier forms back (k1_split.py, PERF.md): in qmatmul.cu a
// band copied by cp.async, a __syncthreads a K step, one tile at a time a
// CTA and products and fragment loads a third of the time; in
// qmatmul_sm90n.cu the halo's rows computed and dropped (1.27x the rows at
// 16x16) and an epilogue with no product in flight.
//
// What the design does about it:
// - No halo rows: persistent CTAs walk work items of TR output rows of an
//   image (the whole image at large batches, a half or a quarter where
//   whole images would leave consumers idle). A producer warp brings each
//   item's image rows as they lie (contiguous in NHWC) by one bulk copy
//   into the stage of the consumer that takes it, signalled by mbarriers
//   (full when its bytes land, empty when the consumer has read it). A
//   first form laid the planes out by TMA boxes of 16 bytes a row
//   (column-shifted, and sampled by element strides of 2) and was bound by
//   the boxes' rows (PERF.md).
// - Each consumer warpgroup lays its item out in its own planes, 16
//   channels (a group) 16 bytes a pixel, the halo zero:
//   - stride 1: per group three planes of TR + 2 rows from row -1, at
//     column offsets -1, 0, +1 (dx), so that tap (dy, dx) of an m64 group
//     (64 consecutive outputs) is one start address dy rows into plane dx,
//     rows 16 bytes apart;
//   - stride 2: per group one plane a tap, sampled every other row and
//     column from (dy - 1, dx - 1).
//   No output is computed that is not kept.
// - A K step (32 bytes) is two groups of one tap (the descriptor's second
//   16 bytes a group's planes on) or, for one group, two taps (the second
//   tap's offset on); the taps run in the order in which their planes lie
//   (dx-major at stride 1), so the offset is positive. The weight's K is
//   re-packed once in that order (kernels/qmatmul.py _plane_k_order) in
//   wgmma's no-swizzle core-matrix layout, brought once a CTA by a bulk
//   copy and read by descriptor. The K steps (5 or 9) are a constant, so
//   the products unroll (under a loop of run-time length ptxas fences the
//   accumulators between them, C7519).
// - Four consumer warpgroups take items in turn, so that one's epilogue
//   runs under the others' products and layouts and the producer's copies;
//   each multiplies its item's MC m64 groups at once, waits once, then maps
//   its sums four at a time through site_codes4 (the step table's lookups
//   together), stages a warp's 16 rows (consecutive pixels) in its planes
//   (free once the products are done) and stores them in 16-byte stores.
//
// C interface: k1_plane_launch has k1_narrow_launch's operands (the
// weight re-packed for this form by address) and the map's step table; it
// returns cudaGetLastError() after the launch (or the error that refused
// it). The Python wrapper checks the operands and computes the plan
// (kernels/qmatmul.py plane_plan).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_codes.cuh"
#include "k1_epilogue.cuh"
#include "sm90_common.cuh"

namespace {

using namespace k1;  // ActArgs and the epilogue modes
using namespace sm90;

constexpr int CONSUMERS = 4;                   // consumer warpgroups, each with its own stage
constexpr int THREADS = 128 * CONSUMERS + 32;  // and the producer warp

// The launch plan, in the order kernels/qmatmul.py PlanePlan lays it out.
// Offsets of the shared-memory regions are from the 128-byte aligned base.
struct Plan {
  int B, H, W, C, Ho, Wo, stride, pad, ksize, N8, Kp;
  int G, NBX, TR, TY, n_items;  // groups; planes a group; output rows an item, items an image, items
  int BR, BOXB, steps, KT, MG;  // a plane's rows and bytes; K steps; K bytes of a weight row; m64 groups an item
  int raw_bytes, plane_bytes;   // a stage (an item's image rows at most); a consumer's planes
  int w_off, stage_off, plane_off, tab_off, sb_off, stab_off, bar_off, smem;
};
constexpr int PLAN_INTS = sizeof(Plan) / sizeof(int);

// Byte offset in a consumer's planes of tap tau of group q: plane q * NBX +
// (stride 1: dx, dy rows in; stride 2: the tap's own plane), tau = 3 dx +
// dy at stride 1 (dx-major: the planes' order) and 3 dy + dx at stride 2
__device__ __forceinline__ int tap_off(const Plan& p, int q, int tau) {
  if (p.stride == 1) return (q * p.NBX + tau / 3) * p.BOXB + (tau % 3) * p.Wo * 16;
  return (q * p.NBX + tau) * p.BOXB;
}

// the 128 threads of consumer warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); }

// The image rows item `item` reads: [*ylo, *ylo + *rows), its image *b and
// its first output row *oy0
__device__ __forceinline__ void item_rows(const Plan& p, int item, int* b, int* oy0, int* ylo, int* rows) {
  *b = item / p.TY;
  *oy0 = (item - *b * p.TY) * p.TR;
  *ylo = max(p.stride * *oy0 - 1, 0);
  *rows = min(p.stride * (*oy0 + p.TR - 1) + 1, p.H - 1) - *ylo + 1;
}

template <int MODE, int NB, int STEPS, int MC>
__global__ void __launch_bounds__(THREADS, 1)
k1_plane_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wpk, const float* __restrict__ scale,
                const float* __restrict__ bias, void* __restrict__ out, const Plan p, const ActArgs act,
                const ::act::Table table) {
  constexpr bool CODES = MODE >= POLY;  // int8 outputs (the codes and requant), else 4-byte ones
  constexpr bool TABLE = MODE == POLY || MODE == ERF;
  constexpr int OB = CODES ? 1 : 4;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* wsm = smem + p.w_off;
  int2* tab = reinterpret_cast<int2*>(smem + p.tab_off);  // the map's table
  float* sc = reinterpret_cast<float*>(smem + p.sb_off);  // the scales, then the biases
  int2* stab = reinterpret_cast<int2*>(smem + p.stab_off);  // each K step's A offset and second-half offset
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);  // consumer wg's stage: full[wg], empty[wg]
  uint64_t* empty = full + CONSUMERS;
  uint64_t* wbar = empty + CONSUMERS;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < CONSUMERS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);  // the consumer, once it has laid the item out
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  for (int i = tid; i < NB; i += blockDim.x) {
    sc[i] = scale[i];
    sc[NB + i] = bias[i];
  }
  if (TABLE)
    for (int i = tid; i < table.n; i += blockDim.x) tab[i] = table.tab[i];
  // step k: the group pairs (2j, 2j + 1) tap after tap, then the odd
  // group's taps two at a time (its last tap against zero weights)
  const int pairs = (p.G / 2) * 9;
  for (int k = tid; k < p.steps; k += blockDim.x) {
    if (k < pairs) {
      const int j = k / 9, tau = k - 9 * j;
      const int o = tap_off(p, 2 * j, tau);
      stab[k] = make_int2(o, tap_off(p, 2 * j + 1, tau) - o);
    } else {
      const int tau = 2 * (k - pairs), o = tap_off(p, p.G - 1, tau);
      stab[k] = make_int2(o, tau + 1 < 9 ? tap_off(p, p.G - 1, tau + 1) - o : 16);
    }
  }
  __syncthreads();
  const int my_items = (p.n_items - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;
  const int wg = tid >> 7;
  if (wg == CONSUMERS) {  // the producer warp: the weight, then each item's image rows as they lie
    if ((tid & 31) == 0) {
      mbar_arrive_expect_tx(wbar, NB * p.KT);
      bulk_load(wsm, wpk, NB * p.KT, wbar);
      for (int n = 0; n < my_items; ++n) {
        const int s = n % CONSUMERS;  // item n's consumer and its stage
        int b, oy0, ylo, rows;
        item_rows(p, blockIdx.x + n * gridDim.x, &b, &oy0, &ylo, &rows);
        if (n >= CONSUMERS) mbar_wait(empty + s, ((n / CONSUMERS) - 1) & 1);
        const uint32_t bytes = static_cast<uint32_t>(rows) * p.W * p.C;
        mbar_arrive_expect_tx(full + s, bytes);
        bulk_load(smem + p.stage_off + s * p.raw_bytes, x + (static_cast<size_t>(b) * p.H + ylo) * p.W * p.C, bytes,
                  full + s);
      }
    }
    return;
  }
  const int rt = tid & 127, wq = rt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  unsigned char* planes = smem + p.plane_off + wg * p.plane_bytes;  // this warpgroup's planes
  const uint64_t desc_w = make_desc_plain(wsm, 16 * NB);
  const uint64_t desc_a = make_desc_plain(planes, 0);
  // this thread's column of each plane row, and its first row (a plane row
  // is Wo pixels; 128 % Wo == 0)
  const int col = rt % p.Wo, row0 = rt / p.Wo, rows_step = 128 / p.Wo;
  const unsigned char* raw = smem + p.stage_off + wg * p.raw_bytes;  // this warpgroup's stage
  mbar_wait(wbar, 0);
  for (int n = wg; n < my_items; n += CONSUMERS) {
    int b, oy0, ylo, rows;
    item_rows(p, blockIdx.x + n * gridDim.x, &b, &oy0, &ylo, &rows);
    mbar_wait(full + wg, (n / CONSUMERS) & 1);
    wg_sync(wg);  // every warp of the warpgroup is done with the planes (the last item's stores)
    // the planes: plane (q, a) row r column i is the image's pixel (y, x),
    // its 16 channels from 16 q, zero outside the image
    for (int q = 0; q < p.G; ++q)
      for (int a = 0; a < p.NBX; ++a) {
        const int dy = p.stride == 1 ? 0 : a / 3, dx = p.stride == 1 ? a : a % 3;
        unsigned char* dst = planes + (q * p.NBX + a) * p.BOXB;
        const int xx = p.stride * col + dx - 1;
        const bool x_in = static_cast<unsigned>(xx) < static_cast<unsigned>(p.W);
        for (int r = row0; r < p.BR; r += rows_step) {
          const int y = p.stride == 1 ? oy0 + r - 1 : 2 * (oy0 + r) + dy - 1;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (x_in && static_cast<unsigned>(y) < static_cast<unsigned>(p.H))
            v = *reinterpret_cast<const uint4*>(raw + ((y - ylo) * p.W + xx) * p.C + 16 * q);
          *reinterpret_cast<uint4*>(dst + (r * p.Wo + col) * 16) = v;
        }
      }
    fence_proxy_async();  // the planes' writes visible to wgmma's reads
    wg_sync(wg);
    if (rt == 0) mbar_arrive(empty + wg);  // the item is laid out: its stage is free
    {
      // each step's A descriptor (its start, its second half's offset)
      uint64_t da[STEPS];
#pragma unroll
      for (int k = 0; k < STEPS; ++k) {
        const int2 e = stab[k];
        da[k] = desc_a + (static_cast<uint64_t>(e.y >> 4) << 16) + (e.x >> 4);
      }
      int acc[MC][NB / 2];
#pragma unroll
      for (int mg = 0; mg < MC; ++mg)
#pragma unroll
        for (int i = 0; i < NB / 2; ++i) reg_fence(acc[mg][i]);
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < STEPS; ++k)
#pragma unroll
        for (int mg = 0; mg < MC; ++mg) wgmma_ss<NB>(acc[mg], da[k] + 64 * mg, desc_w + ((k * 32 * NB) >> 4), k);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int mg = 0; mg < MC; ++mg)
#pragma unroll
        for (int i = 0; i < NB / 2; ++i) reg_fence(acc[mg][i]);
      // a warp stages its outputs in the planes once every warp's products
      // are done
      wg_sync(wg);
      unsigned char* ob = planes + wq * 16 * NB * 4;
      // the epilogue: accumulator 4j + 2h + v of group mg is the item's
      // output 64 mg + 16 wq + g + 8h, column 8j + 2t + v; a warp's 16
      // outputs are consecutive pixels, staged and stored 16 bytes a lane
#pragma unroll
      for (int mg = 0; mg < MC; ++mg) {
        const size_t pix0 = (static_cast<size_t>(b) * p.Ho + oy0) * p.Wo + 64 * mg + 16 * wq;
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          const int c0 = 8 * j + 2 * t;
          const int v[4] = {acc[mg][4 * j], acc[mg][4 * j + 1], acc[mg][4 * j + 2], acc[mg][4 * j + 3]};
          const float sv[4] = {sc[c0], sc[c0 + 1], sc[c0], sc[c0 + 1]};
          const float bv[4] = {sc[NB + c0], sc[NB + c0 + 1], sc[NB + c0], sc[NB + c0 + 1]};
          if constexpr (CODES) {
            const int cols[4] = {c0, c0 + 1, c0, c0 + 1};
            int code[4];
            site_codes4<MODE>(v, sv, bv, cols, act, p.N8, tab, table, code);
            *reinterpret_cast<uint16_t*>(ob + g * NB + c0) = pack2(code[0], code[1]);
            *reinterpret_cast<uint16_t*>(ob + (g + 8) * NB + c0) = pack2(code[2], code[3]);
          } else {
            *reinterpret_cast<uint2*>(ob + 4 * (g * NB + c0)) =
                make_uint2(word_value<MODE>(v[0], sv[0], bv[0]), word_value<MODE>(v[1], sv[1], bv[1]));
            *reinterpret_cast<uint2*>(ob + 4 * ((g + 8) * NB + c0)) =
                make_uint2(word_value<MODE>(v[2], sv[2], bv[2]), word_value<MODE>(v[3], sv[3], bv[3]));
          }
        }
        __syncwarp();
        uint4* dst = reinterpret_cast<uint4*>(static_cast<unsigned char*>(out) + pix0 * NB * OB);
        for (int i = lane; i < NB * OB; i += 32) dst[i] = reinterpret_cast<const uint4*>(ob)[i];
        __syncwarp();
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

template <int MODE, int NB, int STEPS, int MC>
int launch(const void* x, const void* wpk, const void* scale, const void* bias, void* out, const Plan& p,
           const ActArgs& a, const act::Table& t, cudaStream_t stream) {
  auto kernel = k1_plane_kernel<MODE, NB, STEPS, MC>;
  static int smem_allowed = 48 * 1024, last_smem = -1, per_sm = 0;
  if (p.smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = p.smem;
  }
  if (p.smem != last_smem) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    last_smem = p.smem;
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = p.n_items < per_sm * sm_count() ? p.n_items : per_sm * sm_count();
  kernel<<<grid, THREADS, p.smem, stream>>>(static_cast<const int8_t*>(x), static_cast<const int8_t*>(wpk),
                                            static_cast<const float*>(scale), static_cast<const float*>(bias), out, p,
                                            a, t);
  return static_cast<int>(cudaGetLastError());
}

template <int NB, int STEPS, int MC>
int dispatch(int mode, const void* x, const void* wpk, const void* scale, const void* bias, void* out, const Plan& p,
             const ActArgs& a, const act::Table& t, cudaStream_t s) {
  switch (mode) {
    case INT32: return launch<INT32, NB, STEPS, MC>(x, wpk, scale, bias, out, p, a, t, s);
    case F32: return launch<F32, NB, STEPS, MC>(x, wpk, scale, bias, out, p, a, t, s);
    case RELU: return launch<RELU, NB, STEPS, MC>(x, wpk, scale, bias, out, p, a, t, s);
    case POLY: return launch<POLY, NB, STEPS, MC>(x, wpk, scale, bias, out, p, a, t, s);
    case ERF: return launch<ERF, NB, STEPS, MC>(x, wpk, scale, bias, out, p, a, t, s);
    case BINS: return launch<BINS, NB, STEPS, MC>(x, wpk, scale, bias, out, p, a, t, s);
    case BINS_INT: return launch<BINS_INT, NB, STEPS, MC>(x, wpk, scale, bias, out, p, a, t, s);
    case REQUANT: return launch<REQUANT, NB, STEPS, MC>(x, wpk, scale, bias, out, p, a, t, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool plan_ok(const Plan& p) {
  if (p.B < 1 || p.ksize != 3 || p.pad != 1 || (p.stride != 1 && p.stride != 2) || (p.C != 16 && p.C != 32) ||
      p.G != p.C / 16 || (p.N8 != 16 && p.N8 != 32) || p.Ho != (p.H - 1) / p.stride + 1 ||
      p.Wo != (p.W - 1) / p.stride + 1 || p.Wo < 8 || 128 % p.Wo || p.TR < 1 || p.Ho % p.TR ||
      p.TY != p.Ho / p.TR || p.n_items != p.B * p.TY || (p.TR * p.Wo) % 64 || p.MG != p.TR * p.Wo / 64 ||
      (p.MG != 1 && p.MG != 2 && p.MG != 4) || (p.N8 == 16 && p.MG != 4) ||
      p.NBX != (p.stride == 1 ? 3 : 9) ||
      p.BR != (p.stride == 1 ? p.TR + 2 : p.TR) || p.BOXB != p.BR * p.Wo * 16 || p.steps != (p.G == 2 ? 9 : 5) ||
      p.KT != 32 * p.steps)
    return false;
  // a stage holds an item's image rows; the planes, the last step's
  // 16-byte overread and the outputs' staging (4 warps' 16 rows in f32)
  const int rows = p.stride * (p.TR - 1) + 3 < p.H ? p.stride * (p.TR - 1) + 3 : p.H;
  return p.w_off == 0 && p.stage_off >= p.N8 * p.KT && p.stage_off % 128 == 0 && p.raw_bytes % 128 == 0 &&
         p.raw_bytes >= rows * p.W * p.C && p.plane_off >= p.stage_off + CONSUMERS * p.raw_bytes &&
         p.plane_off % 128 == 0 && p.plane_bytes % 128 == 0 &&
         p.plane_bytes >= max(p.G * p.NBX * p.BOXB + 16, 4 * 16 * p.N8 * 4) &&
         p.tab_off >= p.plane_off + CONSUMERS * p.plane_bytes && p.tab_off % 16 == 0 &&
         p.sb_off >= p.tab_off + 8 * act::TABLE_MAX && p.sb_off % 16 == 0 && p.stab_off >= p.sb_off + 8 * p.N8 &&
         p.stab_off % 8 == 0 && p.bar_off >= p.stab_off + 8 * p.steps && p.bar_off % 8 == 0 &&
         p.smem >= p.bar_off + 8 * (2 * CONSUMERS + 1);
}

}  // namespace

extern "C" int k1_plane_plan_ints() { return PLAN_INTS; }

// x NHWC int8 (B, H, W, C), 16-byte aligned; wpk the weight re-packed for
// this form (kernels/qmatmul.py _plane_weight: (N8 * KT) int8); scale, bias
// (N8,) f32; out (B * Ho * Wo, N8) of the mode's type; the map's operands
// as k1_narrow_launch's, and its step table (modes poly and erf: entries,
// lo, hi, b_lo, n; act_codes.cuh table_code, relu'd where relu is)
extern "C" int k1_plane_launch(const void* x, const void* wpk, const void* scale, const void* bias, void* out,
                               const int* plan, int mode, const void* bnd, const void* sgn, const void* t1,
                               const void* t2, int g, int relu, const void* entries, float lo, float hi, int b_lo,
                               int n, void* stream) {
  Plan p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < PLAN_INTS; ++i) dst[i] = plan[i];
  if (!plan_ok(p) || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wpk) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || ((mode == POLY || mode == ERF) && (n < 1 || n > act::TABLE_MAX)))
    return static_cast<int>(cudaErrorInvalidValue);
  const ActArgs a{static_cast<const float*>(bnd), static_cast<const int*>(sgn), static_cast<const int*>(t1),
                  static_cast<const int*>(t2), g, relu};
  const act::Table t{static_cast<const int2*>(entries), lo, hi, b_lo, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // N8, K steps (one group or two), m64 groups an item (at N8 = 16, 4 only:
  // plane_plan's items there are whole runs of 4 m64 groups)
#define PLANE_MC(ST)                                                                      \
  switch (p.MG) {                                                                         \
    case 1: return dispatch<32, ST, 1>(mode, x, wpk, scale, bias, out, p, a, t, s);       \
    case 2: return dispatch<32, ST, 2>(mode, x, wpk, scale, bias, out, p, a, t, s);       \
    default: return dispatch<32, ST, 4>(mode, x, wpk, scale, bias, out, p, a, t, s);      \
  }
  if (p.N8 == 16)
    return p.G == 1 ? dispatch<16, 5, 4>(mode, x, wpk, scale, bias, out, p, a, t, s)
                    : dispatch<16, 9, 4>(mode, x, wpk, scale, bias, out, p, a, t, s);
  if (p.G == 1) PLANE_MC(5)
  PLANE_MC(9)
#undef PLANE_MC
}
