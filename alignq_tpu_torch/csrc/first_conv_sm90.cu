// The CIFAR nets' first conv on Hopper, image in: _linear_q of the f32
// image, the 3x3 pad-1 stride-1 conv over its 3 channels on wgmma
// m64nNk32 and K1's epilogue, in one kernel, for sm_90a.
//
// Replaces, at the first conv of ResNet-20/56, DenseNet-40 and
// MobileNet-V2, the TPU kernel alignq_tpu/kernels/qmatmul.py:45
// int8_matmul_dequant as the port ran it there (the image quantized by
// _linear_q in a PyTorch pass, its channels padded to 4 in another, then
// K1's mma.sync conv over K = 36 padded to 64), itself XLA's int8 conv of
// the JAX serving graph (alignq_tpu/kernels/infer.py:131 _linear_q and
// :235 _int8_conv; infer_densenet.py, infer_mobilenet.py). It computes
// what that chain computes, bit for bit:
//     out[b, y, x, n] = epilogue(sum_{dy, dx, c} q(x[b, y+dy-1, x+dx-1, c]) * W[n, dy, dx, c])
// with q(v) = clip(rint(v * inv), +-127), inv the f32 reciprocal of the
// image scale (one f32 rounding, as _linear_q's multiply), the epilogue
// k1_epilogue.cuh's in the modes the sites use: the act codes (the erf
// and poly maps through their step tables, table_code4; bins and
// bins_int directly), relu'd or not, f32 or the stage buffer's requant.
//
// What bounds it on an H100: bytes, the f32 image read once (12 KB an
// image) and the outputs written once (16-32 bytes a pixel, 4x that in
// f32); its 2 * 27 * N int8 operations a pixel take far less.
//
// What the design does about it:
// - K = 27 in one 32-byte K step: a pixel's 3 x 3 x 3 taps are 27 bytes
//   (k = 9 dy + 3 dx + c) and 5 zero bytes; the weight is re-packed once to
//   (N, 32) (kernels/first_conv.py first_weight), resident in shared memory
//   in wgmma's no-swizzle core-matrix order and read by descriptor.
// - Persistent CTAs walk tiles of R output rows of an image. Their R + 2
//   image rows (the halo's inside the image) come by one 1-D bulk copy of
//   f32 (a row is 384 bytes) into a ring of S stages, S - 1 tiles ahead.
// - Every thread quantizes the stage into a band of int8 rows (192 bytes
//   apart, so that the two rows a load instruction reaches lie 16 banks
//   apart), the image's 96 bytes a row at byte 4 and zero pixels on both
//   sides; rows past the image are zero. Two bands alternate, so one
//   __syncthreads a tile suffices.
// - A comes from registers: each lane gathers its 8 K bytes (positions 4t..
//   and 16 + 4t..) of its two rows by byte loads at offsets fixed per lane;
//   a warpgroup builds A for its MG m64 groups (two output rows each),
//   issues their MG wgmmas and waits once.
// - The epilogue maps four sums at once (site_codes4: the step table's
//   lookups issued together), stages a warp's 16 rows (consecutive pixels)
//   in shared memory and writes them in 16-byte stores.
//
// C interface: first_conv_launch returns cudaGetLastError() after the
// launch, or the error that refused it. The wrapper (kernels/first_conv.py)
// checks the operands and computes the plan.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_codes.cuh"
#include "k1_epilogue.cuh"
#include "sm90_common.cuh"

namespace {

using namespace sm90;
using namespace k1;  // ActArgs and the epilogue modes

constexpr int MAX_THREADS = 512;
constexpr int MAX_STAGES = 4;
constexpr int W = 32;             // image columns: the CIFAR side
constexpr int ROW_F32 = W * 3 * 4;  // bytes of an f32 image row
constexpr int QPR = W * 3 / 4;    // 4-byte words of a quantized row
constexpr int RP = 192;           // a band row's pitch in bytes: image pixel x at byte 4 + 3x

// The launch plan, in the order kernels/first_conv.py FirstPlan lays it
// out. Offsets of the shared-memory regions are from the dynamic shared
// memory's base.
struct Plan {
  int B, H, N, R, TY, n_tiles, n_wg, MG, S;  // images, rows; columns out; rows a tile, tiles an image, tiles;
                                             // warpgroups, m64 groups a warpgroup; stages
  int stage_bytes, band_bytes, obuf_bytes;   // a stage, a band, a warp's output buffer
  int w_off, stage_off, band_off, obuf_off, tab_off, sb_off, bar_off, smem;
};
constexpr int PLAN_INTS = sizeof(Plan) / sizeof(int);

// Tile `tile`'s image rows y0 - 1 .. y0 + R, those inside the image, into
// the stage st by one bulk copy, completing on bar (thread 0)
__device__ __forceinline__ void issue_rows(const Plan& p, const float* x, unsigned char* st, uint64_t* bar,
                                           int tile) {
  const int b = tile / p.TY, y0 = (tile - b * p.TY) * p.R;
  const int ylo = max(y0 - 1, 0), yhi = min(y0 + p.R, p.H - 1);
  const uint32_t bytes = static_cast<uint32_t>(yhi - ylo + 1) * ROW_F32;
  mbar_arrive_expect_tx(bar, bytes);
  bulk_load(st, x + (static_cast<size_t>(b) * p.H + ylo) * (W * 3), bytes, bar);
}

// _linear_q of one f32 value as an int8 code in the low byte
__device__ __forceinline__ uint32_t q8(float v, float inv) {
  return static_cast<uint32_t>(static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f))) & 0xff;
}

// Four band bytes at base + off[j] (off[j] < 0: a zero byte) as one word
__device__ __forceinline__ uint32_t gather4(const unsigned char* base, const int* off) {
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (off[j] >= 0) w |= static_cast<uint32_t>(base[off[j]]) << (8 * j);
  return w;
}

template <int MODE, int N, int MG>
__global__ void __launch_bounds__(MAX_THREADS, 1)
first_conv_kernel(const float* __restrict__ x, const int8_t* __restrict__ wpk, const float* __restrict__ scale,
                  const float* __restrict__ bias, const act::Table table, const ActArgs act, float inv,
                  void* __restrict__ out, const Plan p) {
  constexpr bool CODES = MODE >= POLY;  // int8 outputs (the codes and requant), else 4-byte ones
  constexpr bool TABLE = MODE == POLY || MODE == ERF;
  constexpr int OB = CODES ? 1 : 4;  // bytes an output element
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
  if (TABLE)
    for (int i = tid; i < table.n; i += blockDim.x) tab[i] = table.tab[i];
  // both bands zero: their pad pixels stay so (the quantize pass writes
  // bytes 4 .. 99 of a row only)
  for (int i = tid; i < 2 * p.band_bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem + p.band_off)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int my_tiles = (p.n_tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;
  if (tid == 0) {
    mbar_arrive_expect_tx(bars + p.S, 32 * N);
    bulk_load(wsm, wpk, 32 * N, bars + p.S);
    for (int n = 0; n < p.S - 1 && n < my_tiles; ++n)
      issue_rows(p, x, smem + p.stage_off + n * p.stage_bytes, bars + n, blockIdx.x + n * gridDim.x);
  }
  const int wg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // this lane's K bytes: positions 4t + j (A registers a0, a1) and 16 + 4t
  // + j (a2, a3); k = 9 dy + 3 dx + c lies dy rows and 3 dx + c bytes from
  // the window's first byte; 27 .. 31 are zero
  int koff[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = j < 4 ? 4 * t + j : 12 + 4 * t + j;
    koff[j] = k < 27 ? (k / 9) * RP + k % 9 : -1;
  }
  const uint64_t desc_w = make_desc_plain(wsm, 16 * N);
  unsigned char* ob = smem + p.obuf_off + (tid >> 5) * p.obuf_bytes;  // this warp's output buffer
  for (int n = 0; n < my_tiles; ++n) {
    const int tile = blockIdx.x + n * gridDim.x, ahead = n + p.S - 1;
    // the stage of tile n + S - 1 was last read by tile n - 1's quantize
    // pass, which every thread finished before the barrier that ended it
    if (tid == 0 && ahead < my_tiles)
      issue_rows(p, x, smem + p.stage_off + (ahead % p.S) * p.stage_bytes, bars + ahead % p.S,
                 blockIdx.x + ahead * gridDim.x);
    mbar_wait(bars + n % p.S, (n / p.S) & 1);
    const int b = tile / p.TY, y0 = (tile - b * p.TY) * p.R, ylo = max(y0 - 1, 0);
    // the band: image rows y0 - 1 .. y0 + R quantized (band row r is image
    // row y0 - 1 + r), zero outside the image
    unsigned char* band = smem + p.band_off + (n & 1) * p.band_bytes;
    const float4* st = reinterpret_cast<const float4*>(smem + p.stage_off + (n % p.S) * p.stage_bytes);
    for (int i = tid; i < (p.R + 2) * QPR; i += blockDim.x) {
      const int r = i / QPR, q = i - r * QPR, y = y0 - 1 + r;
      uint32_t word = 0;
      if (y >= 0 && y < p.H) {
        const float4 v = st[(y - ylo) * QPR + q];
        word = q8(v.x, inv) | q8(v.y, inv) << 8 | q8(v.z, inv) << 16 | q8(v.w, inv) << 24;
      }
      *reinterpret_cast<uint32_t*>(band + r * RP + 4 + 4 * q) = word;
    }
    __syncthreads();
    if (n == 0) mbar_wait(bars + p.S, 0);
    // products: the warpgroup's m64 groups wg * MG + mg, each output rows
    // 2 (wg MG + mg) and the next of the tile; this warp's 16 rows are
    // output row 2 (wg MG + mg) + (wq >> 1), pixels 16 (wq & 1) + g (h = 0)
    // and + 8 (h = 1), whose windows start at band byte 1 + 3 x
    uint32_t a[MG][4];
#pragma unroll
    for (int mg = 0; mg < MG; ++mg) {
      const int row = 2 * (wg * MG + mg) + (wq >> 1);
      const unsigned char* w0 = band + row * RP + 1 + 3 * (16 * (wq & 1) + g);
      a[mg][0] = gather4(w0, koff);
      a[mg][1] = gather4(w0 + 24, koff);
      a[mg][2] = gather4(w0, koff + 4);
      a[mg][3] = gather4(w0 + 24, koff + 4);
    }
    int acc[MG][N / 2];
#pragma unroll
    for (int mg = 0; mg < MG; ++mg)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) reg_fence(acc[mg][i]);
    __syncwarp();  // wgmma is .aligned: the warp converged
    wgmma_fence();
#pragma unroll
    for (int mg = 0; mg < MG; ++mg) wgmma_rs<N>(acc[mg], a[mg], desc_w, 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int mg = 0; mg < MG; ++mg) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) reg_fence(acc[mg][i]);
#pragma unroll
      for (int i = 0; i < 4; ++i) reg_fence(a[mg][i]);
    }
    // the epilogue: accumulator 4j + 2h + v of group mg is the warp's row
    // g + 8h, column 8j + 2t + v; the warp's 16 rows are 16 consecutive
    // pixels, staged in its buffer and stored 16 bytes a lane
#pragma unroll
    for (int mg = 0; mg < MG; ++mg) {
      const size_t pix0 =
          (static_cast<size_t>(b) * p.H + y0 + 2 * (wg * MG + mg) + (wq >> 1)) * W + 16 * (wq & 1);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int c0 = 8 * j + 2 * t;
        const int v[4] = {acc[mg][4 * j], acc[mg][4 * j + 1], acc[mg][4 * j + 2], acc[mg][4 * j + 3]};
        const float s[4] = {sc[c0], sc[c0 + 1], sc[c0], sc[c0 + 1]};
        const float bb[4] = {sc[N + c0], sc[N + c0 + 1], sc[N + c0], sc[N + c0 + 1]};
        if constexpr (CODES) {
          const int col[4] = {c0, c0 + 1, c0, c0 + 1};
          int code[4];
          site_codes4<MODE>(v, s, bb, col, act, N, tab, table, code);
          *reinterpret_cast<uint16_t*>(ob + g * N + c0) = pack2(code[0], code[1]);
          *reinterpret_cast<uint16_t*>(ob + (g + 8) * N + c0) = pack2(code[2], code[3]);
        } else {
          *reinterpret_cast<uint2*>(ob + 4 * (g * N + c0)) =
              make_uint2(word_value<MODE>(v[0], s[0], bb[0]), word_value<MODE>(v[1], s[1], bb[1]));
          *reinterpret_cast<uint2*>(ob + 4 * ((g + 8) * N + c0)) =
              make_uint2(word_value<MODE>(v[2], s[2], bb[2]), word_value<MODE>(v[3], s[3], bb[3]));
        }
      }
      __syncwarp();
      uint4* dst = reinterpret_cast<uint4*>(static_cast<unsigned char*>(out) + pix0 * N * OB);
      for (int i = lane; i < N * OB; i += 32) dst[i] = reinterpret_cast<const uint4*>(ob)[i];
      __syncwarp();
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

template <int MODE, int N, int MG>
int launch(const void* x, const void* wpk, const void* scale, const void* bias, const act::Table& table,
           const ActArgs& a, float inv, void* out, const Plan& p, cudaStream_t stream) {
  auto kernel = first_conv_kernel<MODE, N, MG>;
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
  const int grid = p.n_tiles < per_sm * sm_count() ? p.n_tiles : per_sm * sm_count();
  kernel<<<grid, threads, p.smem, stream>>>(static_cast<const float*>(x), static_cast<const int8_t*>(wpk),
                                            static_cast<const float*>(scale), static_cast<const float*>(bias), table,
                                            a, inv, out, p);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int MG>
int dispatch(int mode, const void* x, const void* wpk, const void* scale, const void* bias, const act::Table& t,
             const ActArgs& a, float inv, void* out, const Plan& p, cudaStream_t s) {
  switch (mode) {  // the modes of the first convs' sites (no int32 or relu'd f32 one)
    case F32: return launch<F32, N, MG>(x, wpk, scale, bias, t, a, inv, out, p, s);
    case POLY: return launch<POLY, N, MG>(x, wpk, scale, bias, t, a, inv, out, p, s);
    case ERF: return launch<ERF, N, MG>(x, wpk, scale, bias, t, a, inv, out, p, s);
    case BINS: return launch<BINS, N, MG>(x, wpk, scale, bias, t, a, inv, out, p, s);
    case BINS_INT: return launch<BINS_INT, N, MG>(x, wpk, scale, bias, t, a, inv, out, p, s);
    case REQUANT: return launch<REQUANT, N, MG>(x, wpk, scale, bias, t, a, inv, out, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int N>
int by_mg(int mode, const void* x, const void* wpk, const void* scale, const void* bias, const act::Table& t,
          const ActArgs& a, float inv, void* out, const Plan& p, cudaStream_t s) {
  switch (p.MG) {
    case 1: return dispatch<N, 1>(mode, x, wpk, scale, bias, t, a, inv, out, p, s);
    case 2: return dispatch<N, 2>(mode, x, wpk, scale, bias, t, a, inv, out, p, s);
    case 4: return dispatch<N, 4>(mode, x, wpk, scale, bias, t, a, inv, out, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool plan_ok(const Plan& p, int mode) {
  const int ob = mode >= POLY ? 1 : 4;
  if (p.B < 1 || p.H < 1 || (p.N != 16 && p.N != 24 && p.N != 32) || p.n_wg < 1 || 128 * p.n_wg > MAX_THREADS ||
      p.R != 2 * p.MG * p.n_wg || p.H % p.R || p.TY != p.H / p.R || p.n_tiles != p.B * p.TY || p.S < 2 ||
      p.S > MAX_STAGES)
    return false;
  return p.w_off == 0 && p.stage_off >= 32 * p.N && p.stage_off % 128 == 0 &&
         p.stage_bytes >= (p.R + 2) * ROW_F32 && p.stage_bytes % 128 == 0 &&
         p.band_off == p.stage_off + p.S * p.stage_bytes && p.band_bytes >= (p.R + 2) * RP &&
         p.band_bytes % 16 == 0 && p.obuf_off == p.band_off + 2 * p.band_bytes && p.obuf_bytes >= 16 * p.N * ob &&
         p.obuf_bytes % 16 == 0 && p.tab_off >= p.obuf_off + 4 * p.n_wg * p.obuf_bytes && p.tab_off % 16 == 0 &&
         p.sb_off >= p.tab_off + 8 * act::TABLE_MAX && p.sb_off % 16 == 0 && p.bar_off >= p.sb_off + 8 * p.N &&
         p.bar_off % 8 == 0 && p.smem >= p.bar_off + 8 * (p.S + 1);
}

}  // namespace

extern "C" int first_conv_plan_ints() { return PLAN_INTS; }

// x: the f32 images (B, H, 32, 3), contiguous and 16-byte aligned; wpk the
// re-packed weight (N, 32) int8 (kernels/first_conv.py first_weight), scale
// and bias (N,) f32 (unread in modes int32 and bins_int; in requant the
// bias holds the reciprocal of the output's scale); the map's table (modes
// poly and erf: its entries, (n, 2) int32, lo, hi, b_lo; act_codes.cuh
// table_code, relu'd where relu is), or the bins boundaries bnd and the
// bins_int cutpoints sgn, t1, t2 (k1_epilogue.cuh ActArgs); inv the image's
// quantization multiplier; out (B * H * 32, N) of the mode's type (any mode
// but int32 and relu)
extern "C" int first_conv_launch(const void* x, const void* wpk, const void* scale, const void* bias,
                                 const void* entries, float lo, float hi, int b_lo, int n, const void* bnd,
                                 const void* sgn, const void* t1, const void* t2, int g, int relu, int mode,
                                 float inv, void* out, const int* plan, void* stream) {
  Plan p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < PLAN_INTS; ++i) dst[i] = plan[i];
  if (!plan_ok(p, mode) || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wpk) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || ((mode == POLY || mode == ERF) && (n < 1 || n > act::TABLE_MAX)))
    return static_cast<int>(cudaErrorInvalidValue);
  const act::Table table{static_cast<const int2*>(entries), lo, hi, b_lo, n};
  const ActArgs a{static_cast<const float*>(bnd), static_cast<const int*>(sgn), static_cast<const int*>(t1),
                  static_cast<const int*>(t2), g, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.N == 16) return by_mg<16>(mode, x, wpk, scale, bias, table, a, inv, out, p, s);
  if (p.N == 24) return by_mg<24>(mode, x, wpk, scale, bias, table, a, inv, out, p, s);
  return by_mg<32>(mode, x, wpk, scale, bias, table, a, inv, out, p, s);
}
