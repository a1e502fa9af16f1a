// Depthwise 3x3 int8 conv (groups = C) with a fused dequant or act-code
// epilogue, for sm_90a: K1's depthwise form.
//
// Replaces the int8 depthwise conv that the JAX serving graph of
// MobileNet-V2 leaves to XLA (alignq_tpu/kernels/infer_mobilenet.py:39-49,
// conv_general_dilated with feature_group_count = planes), the conv of the
// TPU kernel K1's family (alignq_tpu/kernels/qmatmul.py:45
// int8_matmul_dequant): out[b, oy, ox, c] = epilogue(sum over the 9 taps of
// x[b, oy*s + dy - 1, ox*s + dx - 1, c] * w[dy, dx, c]) (zero off the
// image), pad 1, stride 1 or 2, int32 accumulation.
//
// What bounds it on an H100: one channel a group leaves an MMA nothing to
// contract over, and a 3x3 depthwise conv moves one input byte and one
// (codes) or four (f32) output bytes for 18 operations an output element:
// bytes, on paper. In the act-code modes the epilogue (~40 f32 operations
// an element for erf, a division among them) makes the kernel bound by its
// instruction issue, so the design spends no instruction it can avoid on
// indexing and taps.
//
// What the design does about it (the launch plan, kernels/dwconv.py
// dw_plan, is passed in as ints):
// - A CTA takes a tile: one image, a band of TR output rows and a chunk of
//   CH channels. It copies the tile's input rows with their halo, HR x HC
//   pixels of the chunk's channels, into shared memory once, by cp.async of
//   16 bytes (4 where C is not a multiple of 16); the pad border is
//   zero-filled there, so no tap is bounds-checked. The copy's latency is
//   hidden by the other CTAs of the SM (persistent CTAs with the next
//   band's copy in flight, and two outputs a loop step, measured slower).
// - A thread (threadIdx = quad, row, x group) owns a channel quad of one
//   output row and a run of RUN outputs along x. It keeps its 9 weight
//   words, scale and bias in registers and slides a 3-column window along
//   the run: each input word is read from shared memory once a row (twice
//   at stride 2's shared column).
// - The taps: a column's 3 row words of the quad are transposed with
//   __byte_perm into 4 words, one a channel, holding that channel's 3 taps
//   of the column; one __dp4a a (column, channel) against the
//   likewise-transposed weight column (its 4th byte 0) gives 12 dp4a an
//   output quad in place of 36 byte extracts and 36 multiply-adds.
// - Index math is 32-bit (an image's H*W*C < 2^31, checked by the plan),
//   with no division in any loop: the band copy steps its (row, column,
//   piece) indices by carries.
// - The row pitch of the band is padded so that the lanes of a warp (the
//   quads of up to 32 / quads rows) read distinct banks.
//
// Epilogue rule, as K1's: f32 `acc * scale + bias` is one rounding
// (__fmaf_rn); the codes are act_codes.cuh's poly, erf or bins maps of it,
// with max(code, 0) where relu is set.
//
// C interface: dw_conv_launch returns cudaGetLastError() after the launch.
// Requirements (checked by the Python wrapper, kernels/dwconv.py): x (B, H,
// W, C) int8 contiguous and 16-byte aligned, C % 4 == 0; w (9, C) int8;
// scale and bias (C,) f32; out (B, Ho, Wo, C) of the mode's type.

#include <cuda_runtime.h>
#include <stdint.h>

#include "act_codes.cuh"
#include "dw_common.cuh"

namespace {

using namespace dw;

constexpr int MAX_THREADS = 512;

// Epilogue modes (the wrapper's kernels/dwconv.py _MODE)
enum Mode { INT32 = 0, F32 = 1, POLY = 3, ERF = 4, BINS = 5 };

// The launch plan, in the order kernels/dwconv.py DwPlan lays it out.
struct Plan {
  int B, H, W, C, Ho, Wo, stride;
  int CH, n_chunks;    // channels a tile; chunks
  int TR, n_bands;     // output rows a tile; bands an image
  int RUN, GX;         // outputs a thread along x; thread groups along x
  int HR, HC, P, RP;   // band rows, cols; smem pixel pitch, row pitch (bytes)
  int vec, threads, smem;  // cp.async bytes; threads a CTA; bytes of the band
};
constexpr int PLAN_INTS = sizeof(Plan) / sizeof(int);

struct ActArgs {
  const float* bnd;  // BINS: the g f32 erf-grid boundaries
  int g, relu;
};

// cp.async of `bytes` (4 or 16); src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}

template <int MODE>
__device__ __forceinline__ int dw_code(int acc, float s, float b, const ActArgs& a) {
  const float h = __fmaf_rn(static_cast<float>(acc), s, b);
  const float gf = static_cast<float>(a.g);
  int code;
  if (MODE == POLY) code = act::poly_code(h, gf);
  else if (MODE == ERF) code = act::erf_code(h, gf);
  else code = act::bins_code(h, a.bnd, a.g);
  return a.relu ? max(code, 0) : code;
}

template <int MODE>
__device__ __forceinline__ void store_quad(unsigned char* px, const int (&acc)[4], const float (&s)[4],
                                           const float (&b)[4], const ActArgs& a) {
  if (MODE == INT32) {
    *reinterpret_cast<int4*>(px) = make_int4(acc[0], acc[1], acc[2], acc[3]);
  } else if (MODE == F32) {
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = __fmaf_rn(static_cast<float>(acc[j]), s[j], b[j]);
    *reinterpret_cast<float4*>(px) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      word |= (static_cast<uint32_t>(dw_code<MODE>(acc[j], s[j], b[j], a)) & 0xff) << (8 * j);
    *reinterpret_cast<uint32_t*>(px) = word;
  }
}

struct Tile {
  int c0, ch, oy0, b;  // first channel, channels; first output row; image
};

// tile = (b * n_bands + band) * n_chunks + chunk
__device__ __forceinline__ Tile tile_at(const Plan& p, int tile) {
  const int chunk = tile % p.n_chunks, rest = tile / p.n_chunks;
  const int c0 = chunk * p.CH;
  return {c0, min(p.CH, p.C - c0), (rest % p.n_bands) * p.TR, rest / p.n_bands};
}

// Issue the cp.async copies of a tile's band: HR x HC pixels of its
// channels, input rows oy0*S - 1 on and columns -1 on, zero-filled off the
// image. Piece i = (r * HC + col) * nv + v, stepped by the CTA's threads
// with carries.
template <int S>
__device__ void issue_band(const Plan& p, const int8_t* __restrict__ x, unsigned char* band, const Tile& t,
                           int tid) {
  const int8_t* xb = x + static_cast<size_t>(t.b) * p.H * p.W * p.C;
  const int nth = p.threads, nv = t.ch / p.vec, total = p.HR * p.HC * nv;
  int v = tid % nv, col = (tid / nv) % p.HC, r = tid / nv / p.HC;
  const int dv = nth % nv, dcol = (nth / nv) % p.HC, dr = nth / nv / p.HC;
  const int iy0 = t.oy0 * S - 1;
  for (int i = tid; i < total; i += nth) {
    const int iy = iy0 + r, ix = col - 1;
    const bool in = static_cast<unsigned>(iy) < static_cast<unsigned>(p.H) &&
                    static_cast<unsigned>(ix) < static_cast<unsigned>(p.W);
    const int8_t* src = in ? xb + (iy * p.W + ix) * p.C + t.c0 + v * p.vec : x;
    cp_async(band + r * p.RP + col * p.P + v * p.vec, src, p.vec, in ? p.vec : 0);
    v += dv;
    if (v >= nv) {
      v -= nv;
      ++col;
    }
    col += dcol;
    if (col >= p.HC) {
      col -= p.HC;
      ++r;
    }
    r += dr;
  }
}

// A thread's outputs of a tile whose band has landed: its quad, output row
// and run along x
template <int MODE, int S>
__device__ void compute_tile(const Plan& p, const unsigned char* band, const Tile& t,
                             const int8_t* __restrict__ w, const float* __restrict__ scale,
                             const float* __restrict__ bias, void* __restrict__ out, const ActArgs& a) {
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
  // the window's band columns ox*S, ox*S + 1, ox*S + 2 of the output row's
  // taps (band rows threadIdx.y*S .. + 2)
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
    store_quad<MODE>(orow + ox * p.C * esize, acc, s, b, a);
    if (S == 1) {
      ca = cb;
      cb = cc;
    } else {
      ca = cc;
    }
  }
}

template <int MODE, int S>
__global__ void __launch_bounds__(MAX_THREADS)
dw_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               void* __restrict__ out, const Plan p, const ActArgs a) {
  extern __shared__ __align__(16) unsigned char band[];
  const int tid = threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  const Tile t = tile_at(p, blockIdx.x);
  issue_band<S>(p, x, band, t, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  compute_tile<MODE, S>(p, band, t, w, scale, bias, out, a);
}

template <int MODE, int S>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* out, const Plan& p,
           const ActArgs& a, cudaStream_t stream) {
  auto kern = dw_conv_kernel<MODE, S>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(p.n_chunks * p.n_bands * p.B), block(p.CH / 4, p.TR, p.GX);
  kern<<<grid, block, p.smem, stream>>>(static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                                        static_cast<const float*>(scale), static_cast<const float*>(bias), out,
                                        p, a);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int dispatch(int mode, const void* x, const void* w, const void* scale, const void* bias, void* out,
             const Plan& p, const ActArgs& a, cudaStream_t s) {
  switch (mode) {
    case INT32: return launch<INT32, S>(x, w, scale, bias, out, p, a, s);
    case F32: return launch<F32, S>(x, w, scale, bias, out, p, a, s);
    case POLY: return launch<POLY, S>(x, w, scale, bias, out, p, a, s);
    case ERF: return launch<ERF, S>(x, w, scale, bias, out, p, a, s);
    case BINS: return launch<BINS, S>(x, w, scale, bias, out, p, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int dw_plan_ints() { return PLAN_INTS; }

extern "C" int dw_conv_launch(const void* x, const void* w, const void* scale, const void* bias, void* out,
                              const int* plan, int mode, const void* bnd, int g, int relu, void* stream) {
  Plan p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < PLAN_INTS; ++i) dst[i] = plan[i];
  if (p.C % 4 || p.CH % p.vec || p.threads != p.CH / 4 * p.TR * p.GX || p.threads > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const ActArgs a{static_cast<const float*>(bnd), g, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.stride == 1) return dispatch<1>(mode, x, w, scale, bias, out, p, a, s);
  if (p.stride == 2) return dispatch<2>(mode, x, w, scale, bias, out, p, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
