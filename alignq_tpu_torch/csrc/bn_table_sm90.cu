// DenseNet's BN-act pass over the int8 stage buffer, table form, for
// sm_90a: persistent CTAs whose warps each walk their own tiles of rows,
// every lane at work, the site's table brought once a CTA by one bulk copy.
//
// Replaces, over the int8 buffer, the elementwise pass that XLA fuses ahead
// of every DenseNet conv (alignq_tpu/kernels/infer_densenet.py
// _pre_act_conv_int8buf, _stage_prealloc_int8: bn -> act_q -> relu over the
// live-channel prefix). It computes what quantize.cu's bn_table_kernel
// computes, bit for bit:
//     codes[m, c] = T[x[m, c] & 255][c]   (c < c_live), 0 up to c_out,
// T the site's (256, tab_ld) codes of every int8 value (kernels/quantize.py
// bn_act_table), x the stage buffer (M, ld) read in place.
//
// What bounds it on an H100: bytes, c_live in and c_out out a row (0.0044
// ms at DenseNet-40's first site at batch 256, 0.0269 at its widest of block
// 1). The rows lie at a pitch ld of 168, 312 or 456 bytes, so a narrow
// site's live prefix costs more of DRAM's 32-byte sectors than its bytes.
// What held bn_table_kernel back (PERF.md): at a narrow site a warp
// took one row a step with only c_out / 4 of its lanes at work (8 rows in
// flight a lane); a grid cut into 128-channel chunks, so that a wide site
// gave each chunk a fraction of the CTAs; and each CTA copying its table
// slice through registers before its first row load.
//
// What the design does about it:
// - Persistent CTAs, up to three an SM where their tables fit (the plan,
//   kernels/quantize.py bn_table_plan; no more CTAs than leave each at
//   least its table's bytes of rows to move). Each warp walks its own tiles
//   of R rows x the whole row, with no barrier of the CTA: no channel
//   chunks in the grid, and a warp gathers while the others' rows are in
//   flight.
// - Work items: one row's 32 quads of a full chunk of 128 channels (lane =
//   quad), or a tail item, RT = 32 / t rows' t tail quads (lane r t + i
//   takes row r's tail quad i), so every lane of a chunk works and a tail
//   item leaves 32 - RT t lanes idle (none at c_out = 32, 64 or 128). A
//   warp loads the x words of U items into registers before it gathers
//   any: U words in flight a lane (U = 8, or 16 where the CTAs do not fill
//   the grid; the plan's).
// - The table comes by one bulk copy on an mbarrier, waited for only after
//   the warp's first rows are in flight. It is the site's table re-laid out
//   once on the host (kernels/quantize.py bn_table_layout) at a pitch P, a
//   multiple of 128 bytes, so that a gather's bank is its column's quad
//   position mod 32 whatever the value: quads 0 .. 32F - 1 as they are
//   (F = c_out / 128 rounded down), then RT replicas of the t tail quads,
//   replica r at quad 32F + r t. In every gather the 32 lanes hit 32
//   distinct banks (tests/test_torch_bn_table_sm90.py checks it on every
//   site's plan). Codes are stored straight to the output: a full item's
//   32 lanes write 128 contiguous bytes.
// - Rows by asynchronous copies into rings in shared memory (8-byte
//   cp.async or bulk copies, a ring a CTA or a warp, codes out by bulk,
//   16-byte or direct stores, the table multicast to clusters) were built
//   and measured slower at all but a few sites (PERF.md): the ring
//   adds shared-memory traffic and barriers that loads straight into
//   registers do not pay.
//
// C interface: bn_table_sm90_launch returns cudaGetLastError() after the
// launch, or the error that refused it. The wrapper (kernels/quantize.py
// bn_act_codes_table) checks the operands and computes the plan.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int THREADS = 512;

// The launch plan, in the order kernels/quantize.py BnTablePlan lays it
// out; the table lies at the base of the dynamic shared memory, its
// mbarrier at bar_off.
struct Plan {
  int M, ld, c_live, c_out;  // rows; the buffer's pitch; live channels; the codes' pitch
  int F, T, RT, P;           // full chunks a row; tail quads; rows a tail item; the table's pitch
  int R, n_tiles, ctas, U;   // rows a warp's tile; tiles; CTAs; work items a warp loads at once
  int bar_off, smem;
};
constexpr int PLAN_INTS = sizeof(Plan) / sizeof(int);

// An item's lane: row r of the tile, channel quad q, the table's column
// pos; whether the lane has work
struct Lane {
  int r, q, pos;
  bool on;
};

// Work item u of a tile of `rows` rows (its rows' F full items first); fm
// = ceil(2^16 / F), so that u / F is (u fm) >> 16 for the u of a tile
__device__ __forceinline__ Lane item_lane(const Plan& p, int u, int n_full, int n_items, int rows, int lane, int tr,
                                          int tq, bool tail_lane, int fm) {
  Lane l;
  if (u < n_full) {  // row r's full chunk: lane = quad
    l.r = (u * fm) >> 16;
    l.q = 32 * (u - l.r * p.F) + lane;
    l.pos = l.q;
    l.on = true;
  } else {  // RT rows' tail quads: lane RT r + i, row r's tail quad i, through replica r
    l.r = (u - n_full) * p.RT + tr;
    l.q = 32 * p.F + tq;
    l.pos = 32 * p.F + lane;
    l.on = tail_lane && l.r < rows && u < n_items;
  }
  return l;
}

// The table's 4 codes of the quad of x values v at the column col (pitch P)
__device__ __forceinline__ uint32_t gather4(uint32_t v, const unsigned char* col, int P) {
  return static_cast<uint32_t>(col[(v & 0xff) * P]) | static_cast<uint32_t>(col[((v >> 8) & 0xff) * P + 1]) << 8 |
         static_cast<uint32_t>(col[((v >> 16) & 0xff) * P + 2]) << 16 |
         static_cast<uint32_t>(col[(v >> 24) * P + 3]) << 24;
}

template <int U>
__global__ void __launch_bounds__(THREADS)
bn_table_sm90_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ tab_g, int8_t* __restrict__ out,
                     const Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* tab = smem;  // (256, P): the table re-laid out
  uint64_t* tab_bar = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  if (tid == 0) {
    mbar_init(tab_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(tab_bar, 256u * p.P);
    bulk_load(tab, tab_g, 256u * p.P, tab_bar);
  }
  const int gw = blockIdx.x * n_warps + warp, total = gridDim.x * n_warps;
  // a tail lane's row within its item and quad position; lanes past RT T idle in tail items
  const int tr = p.T ? lane / p.T : 0, tq = p.T ? lane - tr * p.T : 0;
  const bool tail_lane = p.T && lane < p.RT * p.T;
  const int fm = p.F ? (65536 + p.F - 1) / p.F : 0;
  bool tab_ready = false;
  for (int tile = gw; tile < p.n_tiles; tile += total) {
    const int m0 = tile * p.R, rows = min(p.R, p.M - m0);
    const int n_full = rows * p.F, n_items = n_full + (p.T ? (rows + p.RT - 1) / p.RT : 0);
    const int8_t* xt = x + static_cast<size_t>(m0) * p.ld;
    for (int u0 = 0; u0 < n_items; u0 += U) {
      Lane l[U];
      uint32_t v[U];
#pragma unroll
      for (int i = 0; i < U; ++i) {  // a quad past c_live loads nothing (it may lie past the row): its codes are 0
        l[i] = item_lane(p, u0 + i, n_full, n_items, rows, lane, tr, tq, tail_lane, fm);
        l[i].on = l[i].on && u0 + i < n_items;
        v[i] = l[i].on && 4 * l[i].q < p.c_live
                   ? __ldg(reinterpret_cast<const unsigned int*>(xt + static_cast<size_t>(l[i].r) * p.ld + 4 * l[i].q))
                   : 0u;
      }
      if (!tab_ready) {
        mbar_wait(tab_bar, 0);
        tab_ready = true;
      }
#pragma unroll
      for (int i = 0; i < U; ++i) v[i] = gather4(v[i], tab + 4 * l[i].pos, p.P);  // an idle lane's column is in the table
#pragma unroll
      for (int i = 0; i < U; ++i)
        if (l[i].on) *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m0 + l[i].r) * p.c_out + 4 * l[i].q) = v[i];
    }
  }
  // a warp with no tile never waited: the table must land before its CTA leaves
  if (!tab_ready) mbar_wait(tab_bar, 0);
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

bool plan_ok(const Plan& p) {
  const int full = 32 * p.F, quads = p.c_out / 4;
  if (p.M < 1 || p.ld % 4 || p.c_live % 4 || p.c_out % 4 || p.c_live > p.ld || p.c_live > p.c_out) return false;
  if (quads != full + p.T || p.T < 0 || p.T >= 32 || (p.T && p.RT != 32 / p.T) || (!p.T && p.RT)) return false;
  if (p.P % 128 || p.P < 4 * (full + p.RT * p.T)) return false;
  if (p.R < 1 || p.n_tiles != (p.M + p.R - 1) / p.R || p.ctas < 1 || p.ctas > p.n_tiles ||
      (p.U != 8 && p.U != 16) || p.R * p.F + p.R >= (1 << 12))  // (u fm) >> 16 exact for u < 2^12
    return false;
  return p.bar_off == 256 * p.P && p.smem >= p.bar_off + 8;
}

// One launch: as many CTAs as the plan asks and the card holds at once
template <int U>
int launch(const void* x, const void* table, void* out, const Plan& p, cudaStream_t stream) {
  auto kernel = bn_table_sm90_kernel<U>;
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
  const int grid = p.ctas < per_sm * sm_count() ? p.ctas : per_sm * sm_count();
  kernel<<<grid, THREADS, p.smem, stream>>>(static_cast<const int8_t*>(x), static_cast<const int8_t*>(table),
                                            static_cast<int8_t*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bn_table_sm90_plan_ints() { return PLAN_INTS; }

// x (M, ld) int8 and the re-laid-out table (256, P) int8, 16-byte aligned;
// out (M, c_out) int8, 4-byte aligned
extern "C" int bn_table_sm90_launch(const void* x, const void* table, void* out, const int* plan, void* stream) {
  Plan p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < PLAN_INTS; ++i) dst[i] = plan[i];
  if (!plan_ok(p) || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(table) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.U == 8 ? launch<8>(x, table, out, p, s) : launch<16>(x, table, out, p, s);
}
