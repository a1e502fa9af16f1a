// K1's depthwise form on Hopper: the depthwise 3x3 int8 conv (groups = C)
// of dwconv.cu with its bands brought by TMA into persistent CTAs and the
// erf and poly code maps through their step tables, for sm_90a.
//
// Replaces, as dwconv.cu does, the int8 depthwise conv that the JAX serving
// graph of MobileNet-V2 leaves to XLA (alignq_tpu/kernels/infer_mobilenet.py
// :39-49, conv_general_dilated with feature_group_count = planes), of the
// TPU kernel K1's family (alignq_tpu/kernels/qmatmul.py:45): out[b, oy, ox,
// c] = epilogue(sum over the 9 taps of x[b, oy*s + dy - 1, ox*s + dx - 1, c]
// * w[dy, dx, c]), pad 1, stride 1 or 2, int32 sums; every mode of
// dwconv.cu (int32, f32, the poly, erf and bins codes, relu'd or not), bit
// for bit.
//
// What bounds it on an H100: bytes (one input byte and one (codes) or four
// (f32) output bytes for 18 operations an output element). What held
// dwconv.cu back (PERF.md): its epilogue's erf map (~40 issue slots a code,
// a division among them) and a CTA a tile that waits for its whole band
// (cp.async.wait_group 0 and a sync) before any tap, with no copy under
// any compute but the other CTAs'.
//
// What the design does about it:
// - The band of a tile (CH channels of HR x HC pixels, the halo included)
//   comes by one TMA box of a 4-D tensor map over x (C, W, H, B), from
//   (c0, -1, oy0 * s - 1, b): TMA's zero fill of the box's out-of-bounds
//   parts is the pad, so the copy has no index arithmetic at all.
// - CTAs are persistent with two band buffers on mbarriers: the next
//   tile's band is in flight under this tile's taps and epilogue.
// - The taps are dwconv.cu's (dw_common.cuh: transposed column words, one
//   dp4a a column and channel, a window sliding along a thread's run).
// - The codes: __fmaf_rn, then the map's step table (act_codes.cuh
//   table_code: an entry load and a compare), the bins map by its
//   compares.
//
// C interface: dw_sm90_launch has dw_conv_launch's operands and modes, and
// the table of the map (erf, poly: its entries, lo, hi, b_lo, n); it
// returns cudaGetLastError() after the launch (or the error that refused
// it). The Python wrapper (kernels/dwconv.py) checks the operands and
// computes the plan (dw_sm90_plan).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_codes.cuh"
#include "dw_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace dw;
using namespace sm90;

constexpr int MAX_THREADS = 512;

// Epilogue modes (the wrapper's kernels/dwconv.py _MODE)
enum Mode { INT32 = 0, F32 = 1, POLY = 3, ERF = 4, BINS = 5 };

// The launch plan, in the order kernels/dwconv.py DwSm90Plan lays it out:
// dwconv.cu's Plan (P = CH, RP = HC * CH: the box is dense), then the
// tiles, a band buffer's bytes (the box's, rounded up to 128) and the
// offsets of the table and the mbarriers from the 128-byte aligned base
struct Plan {
  int B, H, W, C, Ho, Wo, stride;
  int CH, n_chunks;
  int TR, n_bands;
  int RUN, GX;
  int HR, HC, P, RP;
  int vec, threads, smem;
  int n_tiles, band_bytes, tab_off, bar_off;
};
constexpr int PLAN_INTS = sizeof(Plan) / sizeof(int);

struct Tile {
  int c0, ch, oy0, b;  // first channel, channels; first output row; image
};

// tile = (b * n_bands + band) * n_chunks + chunk
__device__ __forceinline__ Tile tile_at(const Plan& p, int tile) {
  const int chunk = tile % p.n_chunks, rest = tile / p.n_chunks;
  const int c0 = chunk * p.CH;
  return {c0, min(p.CH, p.C - c0), (rest % p.n_bands) * p.TR, rest / p.n_bands};
}

template <int S>
__device__ __forceinline__ void issue_band(const Plan& p, const CUtensorMap* map, unsigned char* dst, uint64_t* bar,
                                           int tile) {
  const Tile t = tile_at(p, tile);
  mbar_arrive_expect_tx(bar, p.HR * p.RP);  // the box's bytes, its zero fill included
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(t.c0), "r"(-1), "r"(t.oy0 * S - 1), "r"(t.b)
      : "memory");
}

template <int MODE, bool RELU>
__device__ __forceinline__ void store_quad(unsigned char* px, const int (&acc)[4], const float (&s)[4],
                                           const float (&b)[4], const int2* tab, const act::Table& t,
                                           const float* bnd, int g) {
  if (MODE == INT32) {
    *reinterpret_cast<int4*>(px) = make_int4(acc[0], acc[1], acc[2], acc[3]);
  } else if (MODE == F32) {
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = __fmaf_rn(static_cast<float>(acc[j]), s[j], b[j]);
    *reinterpret_cast<float4*>(px) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
    float h[4];
    int code[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __fmaf_rn(static_cast<float>(acc[j]), s[j], b[j]);
    if (MODE == BINS) {
#pragma unroll
      for (int j = 0; j < 4; ++j) code[j] = RELU ? max(act::bins_code(h[j], bnd, g), 0) : act::bins_code(h[j], bnd, g);
    } else {
      act::table_code4<MODE, RELU>(h, code, tab, t.lo, t.hi, t.b_lo, t.n, g);
    }
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) word |= (static_cast<uint32_t>(code[j]) & 0xff) << (8 * j);
    *reinterpret_cast<uint32_t*>(px) = word;
  }
}

// A thread's outputs of a tile whose band has landed: its quad, output row
// and run along x (dwconv.cu's compute_tile on the dense box)
template <int MODE, int S, bool RELU>
__device__ void compute_tile(const Plan& p, const unsigned char* band, const Tile& t, const int8_t* __restrict__ w,
                             const float* __restrict__ scale, const float* __restrict__ bias, void* __restrict__ out,
                             const int2* tab, const act::Table& table, const float* bnd, int g) {
  const int q = threadIdx.x, oy = t.oy0 + threadIdx.y;
  const int ox_begin = threadIdx.z * p.RUN, ox_end = min(ox_begin + p.RUN, p.Wo);
  if (4 * q >= t.ch || oy >= p.Ho || ox_begin >= ox_end) return;
  const int c = t.c0 + 4 * q;
  const QuadWeights qw = load_weights(w, p.C, c);
  float s[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = __ldg(scale + c + j);
    b[j] = __ldg(bias + c + j);
  }
  const unsigned char* row0 = band + threadIdx.y * S * p.RP + 4 * q;
  const int esize = (MODE == INT32 || MODE == F32) ? 4 : 1;
  unsigned char* orow = static_cast<unsigned char*>(out) +
                        (static_cast<size_t>(t.b) * p.Ho * p.Wo * p.C + (oy * p.Wo) * p.C + c) * esize;
  auto col = [&](int band_col) { return load_col(row0 + band_col * p.P, p.RP); };
  Col ca = col(ox_begin * S), cb;
  if (S == 1) cb = col(ox_begin + 1);
  for (int ox = ox_begin; ox < ox_end; ++ox) {
    if (S == 2) cb = col(2 * ox + 1);
    const Col cc = col(ox * S + 2);
    int acc[4];
    tap_sums(ca, cb, cc, qw, acc);
    store_quad<MODE, RELU>(orow + ox * p.C * esize, acc, s, b, tab, table, bnd, g);
    if (S == 1) {
      ca = cb;
      cb = cc;
    } else {
      ca = cc;
    }
  }
}

template <int MODE, int S, bool RELU>
__global__ void __launch_bounds__(MAX_THREADS)
dw_sm90_kernel(const __grid_constant__ CUtensorMap xmap, const int8_t* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias, void* __restrict__ out, const Plan p,
               const act::Table table, const float* __restrict__ bnd, int g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);  // a TMA box's 128-byte alignment
  int2* tab = reinterpret_cast<int2*>(base + p.tab_off);  // the map's table
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + p.bar_off);
  const int tid = threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    mbar_init_fence();
  }
  if (MODE == POLY || MODE == ERF)
    for (int i = tid; i < table.n; i += p.threads) tab[i] = table.tab[i];
  __syncthreads();
  if (tid == 0) issue_band<S>(p, &xmap, base, bars, blockIdx.x);
  int n = 0;  // this CTA's tiles so far
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++n) {
    // the buffer of tile n + 1 was last read by tile n - 1, which every
    // thread finished before the sync that ended it
    const int next = tile + gridDim.x;
    if (tid == 0 && next < p.n_tiles)
      issue_band<S>(p, &xmap, base + ((n + 1) & 1) * p.band_bytes, bars + ((n + 1) & 1), next);
    mbar_wait(bars + (n & 1), (n >> 1) & 1);
    compute_tile<MODE, S, RELU>(p, base + (n & 1) * p.band_bytes, tile_at(p, tile), w, scale, bias, out, tab, table,
                                bnd, g);
    __syncthreads();
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

template <int MODE, int S, bool RELU>
int launch(const CUtensorMap& map, const void* w, const void* scale, const void* bias, void* out, const Plan& p,
           const act::Table& t, const void* bnd, int g, cudaStream_t stream) {
  auto kern = dw_sm90_kernel<MODE, S, RELU>;
  static int smem_allowed = 48 * 1024, last_smem = -1, last_threads = -1, per_sm = 0;
  if (p.smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = p.smem;
  }
  if (p.smem != last_smem || p.threads != last_threads) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, p.threads, p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    last_smem = p.smem;
    last_threads = p.threads;
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int grid = per_sm * sm_count();
  if (grid > p.n_tiles) grid = p.n_tiles;
  const dim3 block(p.CH / 4, p.TR, p.GX);
  kern<<<grid, block, p.smem, stream>>>(map, static_cast<const int8_t*>(w), static_cast<const float*>(scale),
                                        static_cast<const float*>(bias), out, p, t, static_cast<const float*>(bnd),
                                        g);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int dispatch(int mode, int relu, const CUtensorMap& map, const void* w, const void* scale, const void* bias,
             void* out, const Plan& p, const act::Table& t, const void* bnd, int g, cudaStream_t s) {
  switch (mode * 2 + (relu ? 1 : 0)) {
    case INT32 * 2: return launch<INT32, S, false>(map, w, scale, bias, out, p, t, bnd, g, s);
    case F32 * 2: return launch<F32, S, false>(map, w, scale, bias, out, p, t, bnd, g, s);
    case POLY * 2: return launch<POLY, S, false>(map, w, scale, bias, out, p, t, bnd, g, s);
    case POLY * 2 + 1: return launch<POLY, S, true>(map, w, scale, bias, out, p, t, bnd, g, s);
    case ERF * 2: return launch<ERF, S, false>(map, w, scale, bias, out, p, t, bnd, g, s);
    case ERF * 2 + 1: return launch<ERF, S, true>(map, w, scale, bias, out, p, t, bnd, g, s);
    case BINS * 2: return launch<BINS, S, false>(map, w, scale, bias, out, p, t, bnd, g, s);
    case BINS * 2 + 1: return launch<BINS, S, true>(map, w, scale, bias, out, p, t, bnd, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int dw_sm90_plan_ints() { return PLAN_INTS; }

// x (B, H, W, C) int8 (C % 16 == 0, 16-byte aligned); w (9, C) int8;
// scale, bias (C,) f32; out (B, Ho, Wo, C) of the mode's type; for poly and
// erf the map's table (entries (n, 2) int32, lo, hi, b_lo; relu'd where
// relu is set), for bins bnd, the g f32 boundaries
extern "C" int dw_sm90_launch(const void* x, const void* w, const void* scale, const void* bias, void* out,
                              const int* plan, int mode, const void* entries, float lo, float hi,
                              int b_lo, int n, const void* bnd, int g, int relu, void* stream) {
  Plan p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < PLAN_INTS; ++i) dst[i] = plan[i];
  if (p.C % 16 || p.CH % 16 || p.CH > 256 || p.HC > 256 || p.HR > 256 || p.P != p.CH || p.RP != p.HC * p.CH ||
      p.band_bytes < p.HR * p.RP || p.band_bytes % 128 || p.threads != p.CH / 4 * p.TR * p.GX ||
      p.threads > MAX_THREADS || p.tab_off % 16 || p.bar_off % 8 || p.n_tiles < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 || ((mode == POLY || mode == ERF) && (n < 1 || n > act::TABLE_MAX)))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.C), static_cast<cuuint64_t>(p.W),
                              static_cast<cuuint64_t>(p.H), static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(p.C), static_cast<cuuint64_t>(p.C) * p.W,
                                 static_cast<cuuint64_t>(p.C) * p.W * p.H};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(p.CH), static_cast<cuuint32_t>(p.HC),
                             static_cast<cuuint32_t>(p.HR), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUtensorMap map;
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  const act::Table t{static_cast<const int2*>(entries), lo, hi, b_lo, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.stride == 1) return dispatch<1>(mode, relu, map, w, scale, bias, out, p, t, bnd, g, s);
  if (p.stride == 2) return dispatch<2>(mode, relu, map, w, scale, bias, out, p, t, bnd, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
