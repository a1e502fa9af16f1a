// The ImageNet trunks' stem on Hopper: conv1 7x7 stride 2 pad 3 over the
// int8 image, its act codes relu'd, and the 3x3 stride-2 max pool (pad 1)
// of those codes, in one kernel, for sm_90a; and the pass before it that
// quantizes the f32 image to int8 and pads its 3 channels to 4.
//
// Replaces, at the stem, the TPU kernel alignq_tpu/kernels/qmatmul.py:45
// int8_matmul_dequant with XLA's int8 conv and reduce_window around it (the
// JAX serving graph's stem, alignq_tpu/kernels/infer_resnet_imagenet.py
// resnet_imagenet_int8_forward: _linear_q, _conv, _erfq_codes, max, and
// reduce_window). It computes what K1's 7x7 form (qmatmul.cu) and the f16
// max pool after it compute: pooled[b, py, px, n] = max over the 3x3 window
// of max(code(acc * scale[n] + bias[n]), 0), acc the int32 conv sum, code
// the erf or poly map (through its step table, act_codes.cuh table_code) or
// the A4 bins map, stored as int16 (B, Ho/2, Wo/2, 64). Codes are >= 0 after
// the relu, so the pool's zero pad equals JAX's int16.min pad.
//
// What bounds it on an H100: bytes, the int8 image in (3 bytes a pixel)
// and the pooled int16 codes out (256 x 56 x 56 x 64 x 2 bytes at batch
// 256), ~42 us; its 2 * 147 * 64 int8 operations an output pixel take ~30
// us of the tensor cores. What K1's 7x7 form spent its time on (PERF.md):
// the erf map's ~40 issue slots on every conv output, one output row of 64
// pixels a tile (12.5% junk columns at Wo = 112), mma.sync at a quarter of
// wgmma's rate, and three passes of glue around it (the image's quantize,
// its pad to 4 channels, an f16 pool with permutes and casts).
//
// What the design does about it:
// - A tile is R pooled rows of one image: the 2R + 1 conv rows that feed
//   them (the top one shared with the tile above, recomputed) over the
//   whole width, and their input band of 4R + 7 image rows. The band comes
//   by TMA from a 3-D tensor map over the prep pass's image ((W + 4) * 4
//   bytes, H, B) in slabs of 256 bytes of a row. The prep pass writes the
//   conv's 3 pad columns on the left (and one on the right, so a row is a
//   multiple of 16 bytes): a box's first byte must be 16-byte aligned, and
//   a lane's 8-byte loads 8-byte aligned. The pad rows, and the columns
//   past the row, are TMA's zero fill of the boxes' out-of-bounds parts.
//   CTAs are persistent, with two band buffers on mbarriers: the next
//   tile's band is in flight under this tile's products and epilogue.
// - Products on wgmma m64n64k32 s8, K = 7 rows (dy) of 32 bytes: dx 0..7
//   over the 4 channels, dx = 7 and channel 3 against zero weights (K1's Kp
//   = 224). A row of A is 32 bytes of an image row at byte 8 ox - 12, and
//   neighbouring output pixels overlap 8 bytes apart, which no descriptor
//   takes (a core matrix's rows are 16 bytes apart). So A comes from
//   registers: each lane loads its 8 bytes of two rows (pixels dx = 2t, 2t
//   + 1) with one 8-byte load each, and the weight's K is permuted to match
//   (kernels/stem.py stem_weight). A tile's conv outputs are one flat run
//   of m64 groups over (conv row, column), so no group has junk columns but
//   the last.
// - The weight (64 x 224 bytes re-packed into wgmma's core-matrix order,
//   14 KB) comes once a CTA by one bulk copy; B is read by descriptor.
// - The epilogue pools before it maps: the sums go to an int32 tile in
//   shared memory, and each pooled output takes the largest (or, where its
//   column's scale is negative, the least) sum of its 3x3 window, then ONE
//   __fmaf_rn and code: h = acc * s + b rounds monotonically in acc, and the
//   relu'd map is non-decreasing but inside the few-ulp windows where the
//   f32 map is not (act_codes.cuh table_code), so that code is the largest
//   of the window's; where the largest h lies in such a window, the code is
//   the largest of all nine sums' own. The map is the table form (an entry
//   load and a compare). One map a pooled output instead of one a conv
//   output is 5x fewer maps at R = 2 (a tile's 5 conv rows for its 2
//   pooled rows). Codes are stored as int16, 4 channels a thread in 8-byte
//   stores.

// The pass before it (stem_prep_kernel): q = clip(rint(x * inv), +-127) of
// the f32 image, one f32 multiply as the JAX graph's _linear_q, written as
// 4 int8 channels (the 4th zero) in rows of W + 4 pixels, the first 3 and
// the last zero: 4 pixels (16 bytes) a thread. (digit_sm90.cu's conv1
// reads it too, at the digit net's scale.)
//
// C interface: stem_launch and stem_prep_launch return cudaGetLastError()
// after the launch (or the error that refused it); act_table_check counts
// the f32 bit patterns where act_codes.cuh's table form and its direct map
// differ. The Python wrapper (kernels/stem.py) checks the operands and
// computes the plan (stem_plan).

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
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

constexpr int NOUT = 64;                 // the stem's output channels
constexpr int KSTEPS = 7;                // K steps: the kernel's rows (dy)
constexpr int W_STEP = 2048;             // bytes of the re-packed weight a K step (64 x 32)
constexpr int W_BYTES = KSTEPS * W_STEP;  // 14 KB
constexpr int SLAB = 256;                // bytes of an image row a TMA box carries
constexpr int AP = NOUT + 8;             // the int32 tile's pitch: words a conv output pixel
constexpr int TABLE_ROOM = 512;          // a relu'd table's entries at most: the buckets of [0, 4)
constexpr int MAX_THREADS = 512;

// The launch plan, in the order kernels/stem.py StemPlan lays it out.
// Offsets of the shared-memory regions are from the 1024-byte aligned base
// where the first band buffer lies.
struct Plan {
  int B, H, W, Ho, Wo, Hp, Wp;
  int R, CR, BR, NS;          // pooled rows a tile; conv rows (2R + 1); band rows (4R + 7); slabs a band row
  int TY, n_tiles, MT, n_groups, n_wg;  // tiles an image; tiles; conv outputs a tile; its m64 groups; warpgroups
  int band_bytes, w_off, acc_off, tab_off, sb_off, bar_off, smem;
};
constexpr int PLAN_INTS = sizeof(Plan) / sizeof(int);

// The band of tile `tile` into dst: slab s of image rows 4 py0 - 5 ..
// 4 py0 + 4R + 1 from byte 256 s of the padded row (the image's byte
// 256 s - 12), zero off the image
__device__ __forceinline__ void issue_band(const Plan& p, const CUtensorMap* map, unsigned char* dst, uint64_t* bar,
                                           int tile) {
  const int b = tile / p.TY, py0 = (tile - b * p.TY) * p.R;
  mbar_arrive_expect_tx(bar, p.band_bytes);
  for (int s = 0; s < p.NS; ++s) tma_load_3d(dst + s * p.BR * SLAB, map, bar, SLAB * s, 4 * py0 - 5, b);
}

// The largest relu'd code of a window's sums' own (v: its first sum, nr x
// nc of them at row pitch rp words, column pitch AP in the int32 tile); out
// of line, so that the rarely taken branch costs the main path nothing
template <int MODE>
__device__ __noinline__ int window_pool_code(float s, float b, const int* v, int nr, int nc, int rp, int g) {
  const float gf = static_cast<float>(g);
  int code = 0;
  for (int r = 0; r < nr; ++r)
    for (int k = 0; k < nc; ++k) {
      const float hk = __fmaf_rn(static_cast<float>(v[r * rp + k * AP]), s, b);
      code = max(code, MODE == ERF ? act::erf_code(hk, gf) : act::poly_code(hk, gf));
    }
  return code;
}

// The relu'd codes of a pooled output's 4 columns: h = acc * s + b rounds
// monotonically (up in acc where s >= 0, down where s < 0), so the
// window's largest h is that of its largest (mx) or least (mn) sum, and
// its code is the largest code, the relu'd map being non-decreasing
// everywhere but in its windows of a few ulps (act_codes.cuh table_code).
// Where that h lies in a window, the code is the largest of the window's
// sums' own. The four lookups first, then one rarely taken branch.
template <int MODE>
__device__ __forceinline__ void pooled_codes(const int4& mx, const int4& mn, const float* sc, const int* v, int nr,
                                             int nc, int rp, const int2* tab, const act::Table& t, const float* bnd,
                                             int g, int (&code)[4]) {
  const int hi_[4] = {mx.x, mx.y, mx.z, mx.w}, lo_[4] = {mn.x, mn.y, mn.z, mn.w};
  float h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __fmaf_rn(static_cast<float>(sc[j] < 0.f ? lo_[j] : hi_[j]), sc[j], sc[NOUT + j]);
  if (MODE == BINS) {  // compares: non-decreasing everywhere
#pragma unroll
    for (int j = 0; j < 4; ++j) code[j] = max(act::bins_code(h[j], bnd, g), 0);
    return;
  }
  int2 e[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = act::table_entry(h[j], tab, t.b_lo, t.n);
  unsigned in = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    code[j] = act::table_step_code<true>(h[j], e[j], t.lo, t.hi, g);
    in |= static_cast<unsigned>(act::in_window(h[j], e[j])) << j;
  }
  if (in)
    for (int j = 0; j < 4; ++j)
      if ((in >> j) & 1) code[j] = window_pool_code<MODE>(sc[j], sc[NOUT + j], v + j, nr, nc, rp, g);
}

template <int MODE>
__global__ void __launch_bounds__(MAX_THREADS, 1)
stem_kernel(const __grid_constant__ CUtensorMap xmap, const int8_t* __restrict__ wpk, const float* __restrict__ scale,
            const float* __restrict__ bias, const act::Table table, const float* __restrict__ bnd, int g,
            int16_t* __restrict__ out, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* wsm = base + p.w_off;
  int* accs = reinterpret_cast<int*>(base + p.acc_off);  // the tile's conv sums, (MT, AP) int32
  int2* tab = reinterpret_cast<int2*>(base + p.tab_off);  // the map's table
  float* sc = reinterpret_cast<float*>(base + p.sb_off);  // the scales, then the biases
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + p.bar_off);  // the two band buffers', the weight's

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    mbar_init(bars + 2, 1);
    mbar_init_fence();
  }
  for (int i = tid; i < NOUT; i += blockDim.x) {
    sc[i] = scale[i];
    sc[NOUT + i] = bias[i];
  }
  if (MODE != BINS)
    for (int i = tid; i < table.n; i += blockDim.x) tab[i] = table.tab[i];
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bars + 2, W_BYTES);
    bulk_load(wsm, wpk, W_BYTES, bars + 2);
    issue_band(p, &xmap, base, bars, blockIdx.x);
  }

  const int wg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const uint64_t desc_w = make_desc_plain(wsm, 1024);
  int n = 0;  // this CTA's tiles so far
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++n) {
    const int next = tile + gridDim.x;
    // the buffer of tile n + 1 was last read by tile n - 1, whose products
    // every thread finished before the sync that ended it
    if (tid == 0 && next < p.n_tiles)
      issue_band(p, &xmap, base + ((n + 1) & 1) * p.band_bytes, bars + ((n + 1) & 1), next);
    mbar_wait(bars + (n & 1), (n >> 1) & 1);
    if (n == 0) mbar_wait(bars + 2, 0);
    const unsigned char* band = base + (n & 1) * p.band_bytes;
    const int b = tile / p.TY, py0 = (tile - b * p.TY) * p.R, oy0 = 2 * py0 - 1;

    // products, an m64 group of the tile's conv outputs at a time, their
    // sums into the int32 tile
    for (int grp = wg; grp < p.n_groups; grp += p.n_wg) {
      int off[2];  // band offsets of this lane's 8 bytes of its two rows, at dy = 0
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min(64 * grp + 16 * wq + gq + 8 * h, p.MT - 1);
        const int r = m / p.Wo, ox = m - r * p.Wo, pos = 8 * ox + 8 * t;  // padded row byte of pixel 2 ox - 3 + 2t
        off[h] = (pos / SLAB) * p.BR * SLAB + 2 * r * SLAB + pos % SLAB;
      }
      uint32_t a[KSTEPS][4];
#pragma unroll
      for (int dy = 0; dy < KSTEPS; ++dy) {
        const uint2 lo = *reinterpret_cast<const uint2*>(band + off[0] + dy * SLAB);
        const uint2 hi = *reinterpret_cast<const uint2*>(band + off[1] + dy * SLAB);
        a[dy][0] = lo.x;
        a[dy][2] = lo.y;
        a[dy][1] = hi.x;
        a[dy][3] = hi.y;
      }
      int acc[NOUT / 2];
#pragma unroll
      for (int i = 0; i < NOUT / 2; ++i) reg_fence(acc[i]);
      __syncwarp();  // wgmma is .aligned: the warp converged after its waits
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < KSTEPS; ++dy) wgmma_rs<NOUT>(acc, a[dy], desc_w + ((dy * W_STEP) >> 4), dy);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NOUT / 2; ++i) reg_fence(acc[i]);
#pragma unroll
      for (int dy = 0; dy < KSTEPS; ++dy)  // the products read A from these registers until the wait
#pragma unroll
        for (int i = 0; i < 4; ++i) reg_fence(a[dy][i]);
      // accumulator 4j + 2h + v is row 16 wq + gq + 8h of the group, column
      // 8j + 2t + v (the pitch AP keeps a half-warp's 8-byte stores on
      // distinct banks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 64 * grp + 16 * wq + gq + 8 * h;
        if (m >= p.MT) continue;
#pragma unroll
        for (int j = 0; j < NOUT / 8; ++j)
          *reinterpret_cast<int2*>(accs + m * AP + 8 * j + 2 * t) =
              make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    __syncthreads();
    // the pool: pooled row py0 + i takes conv rows 2i .. 2i + 2 of the tile,
    // column px conv columns 2 px - 1 .. 2 px + 1; conv row -1 and column -1
    // are the zero pad, which no relu'd code is below, so they are left out.
    // 4 columns a thread, their codes stored as int16 in one 8-byte store
    for (int u = tid; u < p.R * p.Wp * (NOUT / 4); u += blockDim.x) {
      const int c4 = u % (NOUT / 4), pc = u / (NOUT / 4), i = pc / p.Wp, px = pc - i * p.Wp, py = py0 + i;
      if (py >= p.Hp) continue;
      const int r0 = oy0 + 2 * i < 0 ? 1 : 0, c0 = px == 0 ? 1 : 0;  // the pad row and column left out
      const int* v = accs + ((2 * i + r0) * p.Wo + 2 * px - 1 + c0) * AP + 4 * c4;
      int4 mx = make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN), mn = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
#pragma unroll
      for (int rr = 0; rr < 3; ++rr)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          if (rr < 3 - r0 && cc < 3 - c0) {
            const int4 q = *reinterpret_cast<const int4*>(v + (rr * p.Wo + cc) * AP);
            mx = make_int4(max(mx.x, q.x), max(mx.y, q.y), max(mx.z, q.z), max(mx.w, q.w));
            mn = make_int4(min(mn.x, q.x), min(mn.y, q.y), min(mn.z, q.z), min(mn.w, q.w));
          }
        }
      const int c = 4 * c4;
      int k[4];
      pooled_codes<MODE>(mx, mn, sc + c, v, 3 - r0, 3 - c0, p.Wo * AP, tab, table, bnd, g, k);
      *reinterpret_cast<uint2*>(out + ((static_cast<size_t>(b) * p.Hp + py) * p.Wp + px) * NOUT + c) =
          make_uint2(static_cast<uint32_t>(k[0]) | static_cast<uint32_t>(k[1]) << 16,
                     static_cast<uint32_t>(k[2]) | static_cast<uint32_t>(k[3]) << 16);
    }
    __syncthreads();  // the int32 tile is free, and every thread is done with this band
  }
}

// q (B, H, W + 4, 4) int8 = clip(rint(x * inv), +-127) of x (B, H, W, 3)
// f32, the 4th channel 0, columns 0..2 and W + 3 zero: four padded pixels
// (16 bytes) a thread
__global__ void stem_prep_kernel(const float* __restrict__ x, uint4* __restrict__ q, long long n_quads, int W,
                                 float inv) {
  const int qpr = (W + 4) / 4;  // quads a padded row
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n_quads;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / qpr;
    const int x0 = 4 * static_cast<int>(i - row * qpr) - 3;  // the image column of the quad's first pixel
    const float* src = x + row * W * 3;
    uint32_t w[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t word = 0;
      if (x0 + p >= 0 && x0 + p < W) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int v = static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(src[3 * (x0 + p) + c], inv)), -127.f), 127.f));
          word |= (static_cast<uint32_t>(v) & 0xff) << (8 * c);
        }
      }
      w[p] = word;
    }
    q[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// diffs[0] += the f32 bit patterns (a 2^32 / gridDim share a CTA) where the
// table form and the direct map of grid g (relu'd where RELU) differ;
// diffs[1] = the least one
template <int IMPL, bool RELU>
__global__ void table_check_kernel(const act::Table table, int g, unsigned long long* diffs) {
  __shared__ int2 tab[act::TABLE_MAX];
  for (int i = threadIdx.x; i < table.n; i += blockDim.x) tab[i] = table.tab[i];
  __syncthreads();
  const float gf = static_cast<float>(g);
  unsigned int n_diff = 0;
  for (unsigned long long i = blockIdx.x * static_cast<unsigned long long>(blockDim.x) + threadIdx.x;
       i < (1ull << 32); i += static_cast<unsigned long long>(gridDim.x) * blockDim.x) {
    const float h = __uint_as_float(static_cast<uint32_t>(i));
    int want = act::direct_code<IMPL>(h, gf);
    if (RELU) want = max(want, 0);
    if (act::table_code<IMPL, RELU>(h, tab, table.lo, table.hi, table.b_lo, table.n, g) != want) {
      ++n_diff;
      atomicMin(diffs + 1, i);
    }
  }
  if (n_diff) atomicAdd(diffs, static_cast<unsigned long long>(n_diff));
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
int launch(const CUtensorMap& map, const void* wpk, const void* scale, const void* bias, const act::Table& table,
           const void* bnd, int g, void* out, const Plan& p, cudaStream_t stream) {
  auto kernel = stem_kernel<MODE>;
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
  int grid = per_sm * sm_count();
  if (grid > p.n_tiles) grid = p.n_tiles;
  kernel<<<grid, threads, p.smem, stream>>>(map, static_cast<const int8_t*>(wpk), static_cast<const float*>(scale),
                                            static_cast<const float*>(bias), table,
                                            static_cast<const float*>(bnd), g, static_cast<int16_t*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stem_plan_ints() { return PLAN_INTS; }

// xq (B, H, W + 4, 4) int8 (the prep pass's, W % 4 == 0, 16-byte aligned), wpk the re-packed
// weight (W_BYTES, 16-byte aligned), scale and bias (64,) f32, the relu'd
// map's table (modes poly and erf: its entries, (n, 2) int32, lo, hi, b_lo;
// act_codes.cuh table_code) or bnd its g f32 boundaries
// (bins), out (B, Hp, Wp, 64) int16
extern "C" int stem_launch(const void* xq, const void* wpk, const void* scale, const void* bias, const void* entries,
                           float lo, float hi, int b_lo, int n, const void* bnd, int g, int mode,
                           void* out, const int* plan, void* stream) {
  Plan p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < PLAN_INTS; ++i) dst[i] = plan[i];
  if (p.n_wg < 1 || 128 * p.n_wg > MAX_THREADS || p.CR != 2 * p.R + 1 || p.BR != 4 * p.R + 7 || p.BR > 256 ||
      p.MT != p.CR * p.Wo || p.n_groups * 64 < p.MT || p.Ho != 2 * p.Hp || p.Wo != 2 * p.Wp || p.W % 4 ||
      p.NS * SLAB < 8 * p.Wo + 24 || p.band_bytes != p.NS * p.BR * SLAB || p.w_off % 16 || p.acc_off % 16 ||
      p.tab_off % 16 || p.sb_off % 16 || p.bar_off % 8 || p.n_tiles < 1 ||
      reinterpret_cast<uintptr_t>(xq) % 16 || reinterpret_cast<uintptr_t>(wpk) % 16 ||
      (mode != BINS && (n < 1 || n > TABLE_ROOM)))
    return static_cast<int>(cudaErrorInvalidValue);
  const act::Table table{static_cast<const int2*>(entries), lo, hi, b_lo, n};
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t row = 4 * (p.W + 4);  // bytes of a padded row
  const cuuint64_t dims[3] = {row, static_cast<cuuint64_t>(p.H), static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[2] = {row, row * p.H};
  const cuuint32_t box[3] = {SLAB, static_cast<cuuint32_t>(p.BR), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUtensorMap map;
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(xq), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case POLY: return launch<POLY>(map, wpk, scale, bias, table, bnd, g, out, p, s);
    case ERF: return launch<ERF>(map, wpk, scale, bias, table, bnd, g, out, p, s);
    case BINS: return launch<BINS>(map, wpk, scale, bias, table, bnd, g, out, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q (rows, W + 4, 4) int8 from x (rows, W, 3) f32; W % 4 == 0, q 16-byte aligned
extern "C" int stem_prep_launch(const void* x, void* q, long long rows, int W, float inv, void* stream) {
  if (W % 4 || W < 4 || reinterpret_cast<uintptr_t>(q) % 16) return static_cast<int>(cudaErrorInvalidValue);
  const long long quads = rows * ((W + 4) / 4);
  long long blocks = (quads + 255) / 256;
  if (blocks > 8L * 132 * 8) blocks = 8L * 132 * 8;
  if (blocks < 1) blocks = 1;
  stem_prep_kernel<<<static_cast<int>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint4*>(q), quads, W, inv);
  return static_cast<int>(cudaGetLastError());
}

// diffs (2,) uint64 on the device, set to {0, ~0} by the caller: the
// count of f32 bit patterns where the table form (entries, lo, hi, b_lo,
// n as for stem_launch) of the erf (mode 4) or poly (3) map of grid g,
// relu'd or not, or of K2's map (act::AS, g 127, not relu'd), differs from
// the direct map, and the least one
extern "C" int act_table_check(const void* entries, float lo, float hi, int b_lo, int n,
                               int mode, int g, int relu, void* diffs, void* stream) {
  if (n < 1 || n > act::TABLE_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const act::Table t{static_cast<const int2*>(entries), lo, hi, b_lo, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = 8 * sm_count();
  auto* d = static_cast<unsigned long long*>(diffs);
  if (mode == ERF && relu) table_check_kernel<ERF, true><<<blocks, 512, 0, s>>>(t, g, d);
  else if (mode == ERF) table_check_kernel<ERF, false><<<blocks, 512, 0, s>>>(t, g, d);
  else if (mode == POLY && relu) table_check_kernel<POLY, true><<<blocks, 512, 0, s>>>(t, g, d);
  else if (mode == POLY) table_check_kernel<POLY, false><<<blocks, 512, 0, s>>>(t, g, d);
  else if (mode == act::AS && g == 127 && !relu) table_check_kernel<act::AS, false><<<blocks, 512, 0, s>>>(t, g, d);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
