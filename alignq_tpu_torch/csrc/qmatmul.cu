// K1: int8 implicit-GEMM NHWC conv (and GEMM) with a fused dequant or
// act-code epilogue, for sm_90a.
//
// Replaces the TPU kernel alignq_tpu/kernels/qmatmul.py:45
// int8_matmul_dequant (body _qmm_kernel), y = relu?((x @ w) * scale + bias),
// and XLA's int8 conv_general_dilated that the JAX serving graph calls
// (alignq_tpu/kernels/infer.py _int8_conv_acc): PyTorch has no int8 conv on
// CUDA. It reads the int8 codes x (B, H, W, C) in place and writes the
// (B*Ho*Wo, N8) result: out[m, n] = epilogue(sum_k A[m, k] * W[n, k]) with
// A[m, (dy, dx, c)] = x[b, oy*s + dy - pad, ox*s + dx - pad, c] (zero off the
// image), ksize 3 (pad 1), 1 (pad 0), 7 (pad 3: the ImageNet ResNets' stem
// over the image's channels padded to 4) or 5 (pad 0: the digit DANN's
// VALID convs, conv1 over the image's channels padded to 4), stride 1 or 2.
// The GEMM form
// (x (M, Kp) @ W^T) is the 1x1 stride-1 conv over the (1, 1, M, Kp) view.
// The 3x3 and 1x1 convs over C % 32 == 0 channels to N8 % 64 == 0 columns
// run in K1's Hopper form instead (qmatmul_sm90.cu), and most of the
// narrower stride-1 3x3s and 1x1s in its narrow Hopper form
// (qmatmul_sm90n.cu), chosen by kernels/qmatmul.py k1_plan; the forms share
// their epilogue (k1_epilogue.cuh) and agree bit for bit.
//
// What bounds it on an H100, at the serving graph's shapes: bytes for most
// convs. With the input read once, a 3x3 conv does 2*9*C*N operations for
// every output pixel against C input bytes and N (codes) output bytes:
// 21-288 int8 operations a byte for the stem, the 1x1 skips and the C <= 32
// convs, far under the card's ridge of ~590 (1,979 TOP/s over 3.35 TB/s).
// The C=64 block-6 conv1 sits at ~570, where mma.sync's own rate (well
// under the 1,979 TOP/s of wgmma) sets the pace. At the serving batch 256
// every launch's bound is 0.5-1.9 us, and a CTA's serial chain over its
// one or few tiles (weight and band loads, K loop, epilogue) sets the time.
//
// What the design does about it:
// - A CTA's output tile is a band of TR x TW output pixels of one image.
//   Its input band with the halo is copied into shared memory once, by
//   cp.async, zero-filled at the pad border; the 9 (or 49) taps are offsets
//   into that buffer (a table per k-word), so no input byte is fetched
//   once for each tap. The 7x7 stem's band, for a one-row tile of TW
//   outputs at stride 2, is 7 x (2*TW + 5) pixels of 4 bytes, each k-word
//   one tap of one pixel. With pad 0 (the 5x5 form) the band has no halo:
//   it starts at the tile's first input pixel, and the rows and columns a
//   ragged tile reaches past the image are zero-filled like a pad border;
//   no output that lands reads them.
// - The packed weight (N8, Kp) is resident in shared memory for the whole
//   kernel where it fits (every CIFAR ResNet conv: at most 128 x 288 or
//   64 x 576 bytes). Where it does not, K streams in chunks, weight chunk beside
//   input chunk: a 1x1 conv (and the GEMM) in chunks of 128 channels; a 3x3
//   conv (DenseNet's convs over 200 and more channels, the ImageNet
//   ResNets' from 128 channels) in chunks of CC channels, each with its 9
//   taps: the band of the chunk's channels with its halo, and the weight's
//   (tap, channel) columns of those channels. The last chunk may be
//   narrower; its K is zero-padded to 32 by zero-filled weight columns.
//   Where K streams, each warp keeps the accumulators of one 32-row group
//   of the tile over the chunks (the plan sizes the tile so).
// - Output widths above 256 (MobileNet's 384-1280) split N into n_blocks
//   blocks of NB <= 256 columns, a grid dimension (blockIdx.y): each block
//   keeps its own weight rows, and reads the input bands again (from L2).
// - CTAs are persistent: a CTA walks tiles blockIdx.x, + gridDim.x, ... and
//   its steps (tile, K chunk) go through a ring of 2-4 stage buffers (as
//   many as the plan fits in the budget), so the next steps' cp.async loads
//   are in flight while the current one runs its MMAs and epilogue: a band
//   is small (0.8-13 KB), so one step ahead would leave the loads bound by
//   the memory's latency. The grid is the SMs times the CTAs an SM holds
//   (occupancy API), at most the tile count.
// - Shared-memory pitches are chosen by the launch plan (kernels/qmatmul.py
//   conv_plan) so that the 32 lanes of a fragment load hit 32 distinct
//   banks: the 8 rows g of a fragment are 8 pixels of one output row, so a
//   pixel pitch P with (stride*P/4) % 8 == 4 spreads them over the 8 groups
//   of 4 banks that the 4 lanes t fill.
// - Each warp holds 2 m16 x 4 n8 MMA tiles (mma.sync m16n8k32 s8): 8 A and
//   8 B fragment words feed 8 MMAs a K step.
//
// Epilogue rule: f32 `acc * scale + bias` is ONE rounding (__fmaf_rn), the
// same as the JAX graph's contracted multiply-add under jit.
//
// Epilogue modes: the raw int32 accumulator; f32 `acc * scale + bias`
// (with or without relu); or the act-site codes of the serving graph, the
// fused form of K2 (alignq_tpu/kernels/quantize.py:57 cdf_quantize_int8):
// int8 clip(round(c(h) * g), +-g) of h = acc * scale + bias with c the
// poly, erf or boundary-bin map, or bins_int's integer compare chains
// straight on the accumulator (act_codes.cuh). In a codes mode the f32
// (M, N) tensor never reaches device memory. The codes may take relu,
// max(code, 0). And the stage buffer's int8 requant of DenseNet's
// stage_int8 graph (alignq_tpu/kernels/infer_densenet.py _requant_write):
// clip(rint((acc * scale) * inv), +-127), two f32 roundings, inv the f32
// reciprocal of the buffer slice's scale, passed in the bias vector.
//
// C interface: k1_conv_launch returns cudaGetLastError() after the launch
// (or the error that refused it). Requirements (checked by the Python
// wrapper, which also computes the plan): x (B, H, W, C) int8 contiguous,
// C % 4 == 0, 16-byte aligned; wt (N8, Kp) int8 with Kp % 32 == 0, N8 % 8
// == 0; K ordered (dy, dx, c) over the C channels; for bins, bnd holds g
// f32 boundaries; for bins_int, sgn (N8,) and t1, t2 (g, N8) int32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "k1_epilogue.cuh"

namespace {

constexpr int MT = 2;  // m16 MMA tiles a warp
constexpr int NT = 4;  // n8 MMA tiles a warp
constexpr int WARP_ROWS = 16 * MT;
constexpr int WARP_COLS = 8 * NT;
constexpr int MAX_THREADS = 256;

// The launch plan, in the order kernels/qmatmul.py ConvPlan lays it out.
struct Plan {
  int B, H, W, C, Ho, Wo, stride, pad, ksize, N8, Kp;
  int TR, TW, tiles_y, tiles_x, n_tiles;
  int HR, HC, P, RP;  // halo rows, cols; smem pixel pitch, row pitch (bytes)
  int KC, n_chunks;   // K bytes a full stage carries; stages a tile
  int CC, KCL;        // channels a full stage carries; K bytes of the last
  int WP, vec;        // smem weight row pitch; cp.async size (4, 8, 16)
  int koff_bytes, w_bytes, a_bytes, stage_bytes, smem;
  int warps_m, warps_n;
  int n_stages;  // stage buffers in the ring: 2, 3 or 4
  int NB, n_blocks;  // columns of an N block (blockIdx.y); N blocks
};
constexpr int PLAN_INTS = sizeof(Plan) / sizeof(int);

using k1::ActArgs;
using namespace k1;  // the epilogue modes

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async of `bytes` (4, 8 or 16); src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }
// wait until at most n (1, 2 or 3) groups are in flight
__device__ __forceinline__ void cp_wait_n(int n) {
  if (n >= 3) cp_wait<3>();
  else if (n == 2) cp_wait<2>();
  else cp_wait<1>();
}

// a / d, by a shift where d is a power of two (dlog2 >= 0): the shapes of
// the path are, and an integer division costs tens of instructions
__device__ __forceinline__ int div_by(int a, int d, int dlog2) { return dlog2 >= 0 ? a >> dlog2 : a / d; }
__device__ __forceinline__ int log2_or_neg(int d) { return (d & (d - 1)) == 0 ? __ffs(d) - 1 : -1; }

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

struct TileOrigin {
  int b, oy0, ox0;
};

__device__ __forceinline__ TileOrigin tile_origin(const Plan& p, int tile) {
  const int tx = tile % p.tiles_x;
  const int rest = tile / p.tiles_x;
  return {rest / p.tiles_y, (rest % p.tiles_y) * p.TR, tx * p.TW};
}

// Issue the cp.async loads of stage (tile, chunk) into buf: the input band
// of the tile's channels [c0, c0 + CC) and, where the weight streams, the
// chunk's columns of the N block's rows [n0, n0 + nbr): for a 1x1 conv K
// bytes [c0, c0 + KC); for a KS x KS conv each tap's channels [c0, c0 + cc),
// tap after tap, then zeros to the chunk's depth (a multiple of 32).
template <int KS>
__device__ void issue_stage(const Plan& p, const int8_t* __restrict__ x,
                            const int8_t* __restrict__ wt, unsigned char* buf, int tile,
                            int chunk, int n0, int nbr) {
  const TileOrigin o = tile_origin(p, tile);
  // KS 3, 5 and 7: the band (with its halo where pad > 0), every input
  // pixel; KS 1: the strided sample of the pixels the tile reads
  const int ls = KS > 1 ? 1 : p.stride;
  const int iy0 = o.oy0 * p.stride - (KS > 1 ? p.pad : 0);
  const int ix0 = o.ox0 * p.stride - (KS > 1 ? p.pad : 0);
  const int c0 = chunk * p.CC;
  const int cc = min(p.CC, p.C - c0);  // channels of x in this chunk
  const int nv = cc / p.vec, nv_log2 = log2_or_neg(nv);
  const int row_items = p.HC * nv, total = p.HR * row_items;
  // item i = (band row r, item rem of the row), stepped by blockDim.x
  // without a division a step
  int r = threadIdx.x / row_items, rem = threadIdx.x - r * row_items;
  const int dr = blockDim.x / row_items, drem = blockDim.x - dr * row_items;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = div_by(rem, nv, nv_log2), v = rem - c * nv;
    const int iy = iy0 + r * ls, ix = ix0 + c * ls;
    const bool in = static_cast<unsigned>(iy) < static_cast<unsigned>(p.H) &&
                    static_cast<unsigned>(ix) < static_cast<unsigned>(p.W);
    const int8_t* src = in ? x + ((static_cast<size_t>(o.b) * p.H + iy) * p.W + ix) * p.C + c0 + v * p.vec : x;
    cp_async(buf + r * p.RP + c * p.P + v * p.vec, src, p.vec, in ? p.vec : 0);
    rem += drem;
    r += dr;
    if (rem >= row_items) {
      rem -= row_items;
      ++r;
    }
  }
  if (p.n_chunks == 1) return;
  unsigned char* wbuf = buf + p.a_bytes;  // the weight's columns of this chunk, beside it
  if (KS == 1) {
    const int n16 = min(p.KC, p.Kp - c0) / 16;
    for (int i = threadIdx.x; i < nbr * n16; i += blockDim.x) {
      const int n = i / n16, q = i % n16;
      cp_async(wbuf + n * p.WP + q * 16, wt + static_cast<size_t>(n0 + n) * p.Kp + c0 + q * 16, 16, 16);
    }
  } else {
    constexpr int TAPS = KS * KS;
    const int per_row = TAPS * nv;
    for (int i = threadIdx.x; i < nbr * per_row; i += blockDim.x) {
      const int n = i / per_row, rr = i - n * per_row, tap = rr / nv, v = rr - tap * nv;
      cp_async(wbuf + n * p.WP + tap * cc + v * p.vec,
               wt + static_cast<size_t>(n0 + n) * p.Kp + tap * p.C + c0 + v * p.vec, p.vec, p.vec);
    }
    const int kc = chunk == p.n_chunks - 1 ? p.KCL : p.KC;
    const int nz = (kc - TAPS * cc) / 4;  // zero words of the padded tail
    for (int i = threadIdx.x; i < nbr * nz; i += blockDim.x) {
      const int n = i / nz, q = i - n * nz;
      cp_async(wbuf + n * p.WP + TAPS * cc + 4 * q, wt, 4, 0);
    }
  }
}

template <int MODE, int KS>
__global__ void __launch_bounds__(MAX_THREADS)
k1_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
               const float* __restrict__ scale, const float* __restrict__ bias,
               void* __restrict__ out, const Plan p, const ActArgs act_args) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* koff = reinterpret_cast<int*>(smem);          // KS > 1: A byte offset of each k-word
  unsigned char* wres = smem + p.koff_bytes;          // the resident weight
  unsigned char* stages = wres + p.w_bytes;           // the ring of stage buffers

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // MMA fragment group / thread
  const int wm = warp % p.warps_m, wn = warp / p.warps_m;
  const int n_base = wn * WARP_COLS;
  const int mgroups = p.TR * p.TW / WARP_ROWS;
  const int ps = KS > 1 ? p.stride : 1;  // pixel step of one output pixel in the band
  const int tw_log2 = log2_or_neg(p.TW);
  const int n0 = blockIdx.y * p.NB;         // this CTA's N block
  const int nbr = min(p.NB, p.N8 - n0);     // its columns (a multiple of 8)
  // the k-word table of the last chunk (the only one where the weight is
  // resident) follows that of a full chunk
  const int last_words = p.n_chunks > 1 ? p.KC / 4 : 0;

  if (KS > 1) {
    // word q of a chunk of cc channels holds k = 4q..4q+3: tap k / cc,
    // channels k % cc.. (cc % 4 == 0, so a word never straddles taps). The
    // zero-weight tail repeats the last real word, so that its lanes share
    // that word's addresses (a broadcast, not a bank conflict).
    const int ccl = p.C - (p.n_chunks - 1) * p.CC;
    for (int q = tid; q < last_words + p.KCL / 4; q += blockDim.x) {
      const bool last = q >= last_words;
      const int cc = last ? ccl : p.CC;
      const int k = 4 * (last ? q - last_words : q), tap = k / cc, c = k - tap * cc;
      koff[q] = tap < KS * KS ? (tap / KS) * p.RP + (tap % KS) * p.P + c
                              : (KS - 1) * p.RP + (KS - 1) * p.P + cc - 4;
    }
  }
  if (p.n_chunks == 1) {  // the N block's weight rows, resident for the kernel
    const int n16 = p.Kp / 16;
    for (int i = tid; i < nbr * n16; i += blockDim.x) {
      const int n = i / n16, q = i % n16;
      cp_async(wres + n * p.WP + q * 16, wt + static_cast<size_t>(n0 + n) * p.Kp + q * 16, 16, 16);
    }
  }

  const int my_tiles = (p.n_tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;
  const int n_steps = my_tiles * p.n_chunks;
  const int S = p.n_stages;
  // a ring of S stage buffers: S - 1 stages' loads fly while one computes;
  // every step commits one group (empty past the end), so that waiting for
  // all but the S - 1 newest groups means this step's stage has landed
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_steps)
      issue_stage<KS>(p, x, wt, stages + s * p.stage_bytes, blockIdx.x + (s / p.n_chunks) * gridDim.x,
                      s % p.n_chunks, n0, nbr);
    cp_commit();
  }

  int acc[MT][NT][4];
  for (int s = 0; s < n_steps; ++s) {
    const int s1 = s + S - 1;
    if (s1 < n_steps)  // into the buffer the step before this one freed
      issue_stage<KS>(p, x, wt, stages + (s1 % S) * p.stage_bytes,
                      blockIdx.x + (s1 / p.n_chunks) * gridDim.x, s1 % p.n_chunks, n0, nbr);
    cp_commit();
    cp_wait_n(S - 1);
    __syncthreads();

    const int tile = blockIdx.x + (s / p.n_chunks) * gridDim.x;
    const int chunk = s % p.n_chunks;
    const unsigned char* A = stages + (s % S) * p.stage_bytes;
    const unsigned char* Wm = p.n_chunks == 1 ? wres : A + p.a_bytes;
    const bool last_chunk = chunk == p.n_chunks - 1;
    const int nk = (last_chunk ? p.KCL : p.KC) / 32;
    const int* kt = koff + (last_chunk ? last_words : 0);
    const TileOrigin o = tile_origin(p, tile);

    for (int mg = wm; mg < mgroups; mg += p.warps_m) {
      // the tile's output row and column of rows g and g+8 of each m16
      // tile, and their A byte offset: the band pixel of the top-left tap
      int ro[MT][2], co[MT][2], base[MT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = mg * WARP_ROWS + mi * 16 + g + 8 * h;
          ro[mi][h] = div_by(i, p.TW, tw_log2);
          co[mi][h] = i - ro[mi][h] * p.TW;
          base[mi][h] = ro[mi][h] * ps * p.RP + co[mi][h] * ps * p.P;
        }
      if (chunk == 0) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < NT; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0;
      }
      for (int ks = 0; ks < nk; ++ks) {
        // A fragment (16 x 32, row-major): rows g and g+8, k-words t and 4+t
        int o0, o1;
        if (KS > 1) {
          o0 = kt[ks * 8 + t];
          o1 = kt[ks * 8 + 4 + t];
        } else {
          o0 = ks * 32 + 4 * t;
          o1 = o0 + 16;
        }
        uint32_t af[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          af[mi][0] = lds32(A + base[mi][0] + o0);
          af[mi][1] = lds32(A + base[mi][1] + o0);
          af[mi][2] = lds32(A + base[mi][0] + o1);
          af[mi][3] = lds32(A + base[mi][1] + o1);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (n_base + j * 8 < nbr) {
            // B fragment (32 x 8, column-major): column g, the same k-words
            const unsigned char* b = Wm + (n_base + j * 8 + g) * p.WP + ks * 32 + 4 * t;
            const uint32_t b0 = lds32(b), b1 = lds32(b + 16);
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) mma_s8(acc[mi][j], af[mi], b0, b1);
          }
        }
      }
      if (!last_chunk) continue;

      // C fragment: (row g, cols 2t, 2t+1) in acc[..][0..1], row g+8 in [2..3]
      int rows[MT][2];  // output row of each fragment row, -1 past the ragged edge
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int oy = o.oy0 + ro[mi][h], ox = o.ox0 + co[mi][h];
          rows[mi][h] = oy < p.Ho && ox < p.Wo ? (o.b * p.Ho + oy) * p.Wo + ox : -1;
        }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (n_base + j * 8 + 2 * t >= nbr) continue;
        const int col = n0 + n_base + j * 8 + 2 * t;
        float s0 = 0.f, s1 = 0.f, c0 = 0.f, c1 = 0.f;
        if (MODE != INT32 && MODE != BINS_INT) {
          s0 = scale[col], s1 = scale[col + 1], c0 = bias[col], c1 = bias[col + 1];
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (rows[mi][h] < 0) continue;
            store2<MODE>(out, rows[mi][h], col, p.N8, acc[mi][j][2 * h], acc[mi][j][2 * h + 1], s0, s1, c0, c1,
                         act_args);
          }
      }
    }
    __syncthreads();  // the buffer is free for the step S - 1 ahead
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

template <int MODE, int KS>
int launch(const void* x, const void* wt, const void* scale, const void* bias, void* out,
           const Plan& p, const ActArgs& a, cudaStream_t stream) {
  auto kernel = k1_conv_kernel<MODE, KS>;
  const int threads = 32 * p.warps_m * p.warps_n;
  if (threads > MAX_THREADS || p.n_stages < 2 || p.n_stages > 4 || p.n_blocks < 1 || p.n_blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the attribute and the occupancy of the last configuration, kept: a
  // serving forward launches the same shapes again and again
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
  // persistent CTAs: those the SMs hold, over the N blocks
  const int slots = per_sm * sm_count() / p.n_blocks;
  const dim3 grid(p.n_tiles < slots ? p.n_tiles : (slots > 0 ? slots : 1), p.n_blocks);
  kernel<<<grid, threads, p.smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<const float*>(scale), static_cast<const float*>(bias), out, p, a);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int dispatch(int mode, const void* x, const void* wt, const void* scale, const void* bias,
             void* out, const Plan& p, const ActArgs& a, cudaStream_t s) {
  switch (mode) {
    case INT32: return launch<INT32, KS>(x, wt, scale, bias, out, p, a, s);
    case F32: return launch<F32, KS>(x, wt, scale, bias, out, p, a, s);
    case RELU: return launch<RELU, KS>(x, wt, scale, bias, out, p, a, s);
    case POLY: return launch<POLY, KS>(x, wt, scale, bias, out, p, a, s);
    case ERF: return launch<ERF, KS>(x, wt, scale, bias, out, p, a, s);
    case BINS: return launch<BINS, KS>(x, wt, scale, bias, out, p, a, s);
    case BINS_INT: return launch<BINS_INT, KS>(x, wt, scale, bias, out, p, a, s);
    case REQUANT: return launch<REQUANT, KS>(x, wt, scale, bias, out, p, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int k1_plan_ints() { return PLAN_INTS; }

extern "C" int k1_conv_launch(const void* x, const void* wt, const void* scale,
                              const void* bias, void* out, const int* plan, int mode,
                              const void* bnd, const void* sgn, const void* t1,
                              const void* t2, int g, int relu, void* stream) {
  Plan p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < PLAN_INTS; ++i) dst[i] = plan[i];
  const ActArgs a{static_cast<const float*>(bnd), static_cast<const int*>(sgn),
                  static_cast<const int*>(t1), static_cast<const int*>(t2), g, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.ksize == 3) return dispatch<3>(mode, x, wt, scale, bias, out, p, a, s);
  if (p.ksize == 1) return dispatch<1>(mode, x, wt, scale, bias, out, p, a, s);
  if (p.ksize == 7) return dispatch<7>(mode, x, wt, scale, bias, out, p, a, s);
  if (p.ksize == 5) return dispatch<5>(mode, x, wt, scale, bias, out, p, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
