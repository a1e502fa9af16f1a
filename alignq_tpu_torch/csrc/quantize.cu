// K2's first form: CDF-alignment quantization of f32 to int8 codes by the
// direct map, for sm_90a. cdf_quant_sm90.cu is the form the entry point
// launches (kernels/quantize.py cdf_quantize_int8); this one stays for A/B
// runs (quantize._old_form), the card's checks and, on the card, the build
// of the Hopper form's step table (kernels/quantize.py act_table_steps
// runs its bisection and window scan as launches of this kernel, so the
// table is the card's own map, expf's last bit included).
//
// Replaces the TPU kernel alignq_tpu/kernels/quantize.py:57
// cdf_quantize_int8 (body _cdf_quant_kernel, helper _erf_approx):
// q = clip(round(erf(x / sqrt2) * 127), +-127), erf by Abramowitz-Stegun
// 7.1.26, elementwise over f32 of any shape: act_codes.cuh as_code, with
// its rounding rule. Build with no fast-math flags.
//
// What bounds it on an H100: bytes, 4 in and 1 out per element (about 60
// operations an element are far below the card's rate). The TPU kernel
// streamed a padded (rows, 1024) view through VMEM; here the wrapper hands
// over the flat tensor and each thread of a grid-stride loop loads 16 bytes
// of f32 (4 values) and stores their 4 codes as one 4-byte word, so every
// warp reads 512 and writes 128 contiguous bytes a step. The ragged tail
// (n % 4) is done by single-element steps after the loop; nothing is padded.
//
// C interface: cdf_quant_launch returns cudaGetLastError() after the
// launch. Requirements (checked by the Python wrapper): x f32 and 16-byte
// aligned, out int8 with room for n codes.
//
// Beside K2, DenseNet's pre-activation sites: the BN-act code pass
// (bn_act_launch) and its table form (bn_table_launch). They replace the
// elementwise pass that XLA fuses ahead of every DenseNet conv
// (alignq_tpu/kernels/infer_densenet.py _pre_act_conv, _stage_prealloc,
// _stage_prealloc_int8: bn -> act_q -> relu over the live-channel prefix of
// the stage buffer):
//     codes[m, c] = max(map(fma(x[m, c], s[c], b[c])), 0)   (c < c_live)
// x is the f32 stage buffer, or the int8 stage buffer's codes cast to f32
// (s then holds svec * bn.scale, folded once at load); map is
// act_codes.cuh's erf, poly or bins code, so one rounding per multiply-add
// and XLA's erf, as the JAX graph computes under jit. Both read the prefix
// in place, at the buffer's pixel pitch ld, and write contiguous codes at
// a pitch c_out >= c_live, zero past c_live (K1's conv takes c_out
// channels, a multiple of 16).
//
// What bounds them: bytes, 4 (f32) or 1 (int8) in and 1 out an element,
// once ~40 instructions an element of erf arithmetic are paid for.
// - The arithmetic pass (the f32 buffer; and, once a site, the table's
//   build): a 2-D grid of channel chunks x row blocks. A thread keeps the
//   s and b of its V channels (8 where c_out allows: one 8-byte store of
//   codes; 16, twice the registers, measured slower) in registers, and
//   walks rows with 16 / V rows' loads in flight (4 loads of 16 bytes)
//   before it computes their codes. A CTA's channel
//   groups split c_out evenly, so no thread of a chunk idles where c_out
//   is not a multiple of the chunk. Index math is 32-bit, but the row's
//   byte offset.
// - The table form (the int8 buffer): an int8 input takes 256 values, so a
//   site's map is a function of (c, x): codes[m, c] = T[x & 255][c], T the
//   site's (256, c_live) codes of every value (its pitch padded to a
//   multiple of 128), built once by the arithmetic pass over a tensor of
//   every value (kernels/quantize.py bn_act_table; bit-identical by
//   construction). A CTA takes a chunk of 128 channels and a block of rows:
//   it copies the chunk's slice of T, 256 x 128 bytes, into shared memory,
//   then each lane gathers the codes of one channel quad (a warp, one row's
//   128 channels) a row at a time. The slice is laid out [value][channel],
//   so a lane's gathers all fall in its own bank, whatever the values: laid
//   out [channel][value], a gather's bank would be set by its value, and
//   activation codes, clustered near 0, would collide.
//
// C interface: bn_act_launch and bn_table_launch return cudaGetLastError()
// after the launch. Requirements (checked by kernels/quantize.py
// bn_act_codes and bn_act_codes_table): x 16-byte aligned, ld, c_live and
// c_out multiples of 4, c_live <= min(ld, c_out), m_rows < 2^30; the
// table (256, tab_ld) int8, 16-byte aligned, tab_ld a multiple of 128 and
// at least c_live.

#include <cuda_runtime.h>
#include <stdint.h>

#include "act_codes.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CTAS = 132 * 16;  // 16 resident CTAs on each of 132 SMs

__global__ void __launch_bounds__(THREADS)
cdf_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long n4 = n >> 2;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  uint32_t* o4 = reinterpret_cast<uint32_t*>(out);
  for (long long i = first; i < n4; i += stride) {
    const float4 v = x4[i];
    o4[i] = (static_cast<uint32_t>(act::as_code(v.x)) & 0xff) |
            (static_cast<uint32_t>(act::as_code(v.y)) & 0xff) << 8 |
            (static_cast<uint32_t>(act::as_code(v.z)) & 0xff) << 16 |
            (static_cast<uint32_t>(act::as_code(v.w)) & 0xff) << 24;
  }
  for (long long i = (n4 << 2) + first; i < n; i += stride)
    out[i] = static_cast<int8_t>(act::as_code(x[i]));
}

// BN-act maps (the wrapper's kernels/quantize.py _BN_ACT_MODE)
enum BnActMode { POLY = 3, ERF = 4, BINS = 5 };
constexpr int BN_CW_ARITH = 256;     // most channels a CTA chunk of the arithmetic form
constexpr int TB_CH = 128;           // channels a chunk of the table form: 32 lanes of a quad
constexpr int TB_ROWS = 16;          // rows a CTA of the table form takes a step (one a warp)
constexpr int TB_U = 8;              // rows a lane of the table form has in flight
constexpr int TB_CTAS_PER_SM = 2;    // its 32 KB slices: 2 CTAs of 512 threads an SM
constexpr int BN_CTAS_PER_SM = 8;    // CTAs the row blocks aim at: 8 of 256 threads on each SM
constexpr int BN_MIN_STEPS = 2;      // row steps a CTA takes at least

template <int MODE>
__device__ __forceinline__ int bn_act_code(float x, float s, float b, const float* bnd, int g, int relu) {
  const float h = __fmaf_rn(x, s, b);
  const float gf = static_cast<float>(g);
  int code;
  if (MODE == POLY) code = act::poly_code(h, gf);
  else if (MODE == ERF) code = act::erf_code(h, gf);
  else code = act::bins_code(h, bnd, g);
  return relu ? max(code, 0) : code;
}

__device__ __forceinline__ float4 load4(const float* x) { return *reinterpret_cast<const float4*>(x); }
__device__ __forceinline__ float4 load4(const int8_t* x) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(x);
  return make_float4(static_cast<float>(static_cast<int8_t>(v & 0xff)),
                     static_cast<float>(static_cast<int8_t>((v >> 8) & 0xff)),
                     static_cast<float>(static_cast<int8_t>((v >> 16) & 0xff)),
                     static_cast<float>(static_cast<int8_t>(v >> 24)));
}

// V bytes of codes, as V / 4 words, to dst (V-byte aligned)
template <int V>
__device__ __forceinline__ void store_codes(int8_t* dst, const uint32_t (&w)[V / 4]) {
  if constexpr (V == 16) *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (V == 8) *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else *reinterpret_cast<uint32_t*>(dst) = w[0];
}

// Thread (x, y) of a CTA (groups, 256 / groups): channels c .. c + V of
// chunk blockIdx.x (blockDim.x groups of V channels); rows blockIdx.y *
// blockDim.y + y, stepped by the grid's rows, U at a time (their loads
// first, then their codes).
template <typename T, int MODE, int V>
__global__ void __launch_bounds__(THREADS)
bn_act_kernel(const T* __restrict__ x, const float* __restrict__ s, const float* __restrict__ b,
              int8_t* __restrict__ out, int m_rows, int ld, int c_live, int c_out,
              const float* __restrict__ bnd, int g, int relu) {
  constexpr int Q = V / 4, U = 16 / V;
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (c >= c_out) return;
  const int nq = max(0, min(Q, (c_live - c) / 4));  // live quads of the thread's channels
  float sv[V], bv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool live = j < 4 * nq;
    sv[j] = live ? s[c + j] : 0.f;
    bv[j] = live ? b[c + j] : 0.f;
  }
  const int step = blockDim.y * gridDim.y;
  for (int m0 = blockIdx.y * blockDim.y + threadIdx.y; m0 < m_rows; m0 += U * step) {
    float4 v[U][Q];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int m = m0 + u * step;
#pragma unroll
      for (int k = 0; k < Q; ++k)
        v[u][k] = (m < m_rows && k < nq) ? load4(x + static_cast<size_t>(m) * ld + c + 4 * k)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int m = m0 + u * step;
      if (m >= m_rows) break;
      uint32_t w[Q];
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const float e[4] = {v[u][k].x, v[u][k].y, v[u][k].z, v[u][k].w};
        uint32_t word = 0;
        if (k < nq) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            word |= (static_cast<uint32_t>(bn_act_code<MODE>(e[j], sv[4 * k + j], bv[4 * k + j], bnd, g, relu)) &
                     0xff) << (8 * j);
        }
        w[k] = word;
      }
      store_codes<V>(out + static_cast<size_t>(m) * c_out + c, w);
    }
  }
}

// The table form: lane x of warp y of a CTA (32, TB_ROWS) gathers the
// codes of channels c .. c + 4 (c = chunk start + 4x) for the rows
// blockIdx.y * TB_ROWS + y, stepped by the grid's rows, TB_U at a time
// (their loads first, then their codes); tab_ld: T's pitch.
__global__ void __launch_bounds__(32 * TB_ROWS, TB_CTAS_PER_SM)
bn_table_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ table, int tab_ld,
                int8_t* __restrict__ out, int m_rows, int ld, int c_live, int c_out) {
  __shared__ __align__(16) unsigned char tab[256 * TB_CH];  // [value][channel of the chunk]
  const int c0 = blockIdx.x * TB_CH, tid = threadIdx.y * 32 + threadIdx.x;
  if (c0 < c_live) {  // else the chunk holds no live channel, and T no column of it
    const uint4* src = reinterpret_cast<const uint4*>(table + c0);
    for (int i = tid; i < 256 * TB_CH / 16; i += 32 * TB_ROWS)
      reinterpret_cast<uint4*>(tab)[i] = src[(i / (TB_CH / 16)) * (tab_ld / 16) + i % (TB_CH / 16)];
  }
  __syncthreads();
  const int c = c0 + 4 * threadIdx.x;
  if (c >= c_out) return;
  const bool live = c < c_live;  // c_live % 4 == 0: a quad is live or not as a whole
  const unsigned char* col = tab + 4 * threadIdx.x;
  const int step = TB_ROWS * gridDim.y;
  for (int m0 = blockIdx.y * TB_ROWS + threadIdx.y; m0 < m_rows; m0 += TB_U * step) {
    uint32_t v[TB_U];
#pragma unroll
    for (int u = 0; u < TB_U; ++u) {
      const int m = m0 + u * step;
      v[u] = (live && m < m_rows) ? *reinterpret_cast<const uint32_t*>(x + static_cast<size_t>(m) * ld + c) : 0;
    }
#pragma unroll
    for (int u = 0; u < TB_U; ++u) {
      const int m = m0 + u * step;
      if (m >= m_rows) break;
      uint32_t word = 0;
      if (live) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          word |= static_cast<uint32_t>(col[((v[u] >> (8 * j)) & 0xff) * TB_CH + j]) << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m) * c_out + c) = word;
    }
  }
}

// The CTA of a BN-act launch: the c_out / V channel groups split evenly
// into chunks of at most cw channels, blockDim.x groups by 256 / that rows
dim3 bn_block(int c_out, int V, int cw) {
  const int groups = c_out / V, chunks = (groups * V + cw - 1) / cw;
  const int gx = (groups + chunks - 1) / chunks;
  return dim3(gx, THREADS / gx);
}

// The SMs of the current device (the wrapper makes x's device current)
int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// The grid of a BN-act launch: channel chunks x row blocks, the row blocks
// as many as bring the grid to BN_CTAS_PER_SM CTAs an SM, each taking
// BN_MIN_STEPS row steps at least
dim3 bn_grid(int m_rows, int c_out, int V, const dim3& block, int rows_a_thread) {
  const int chunks = (c_out / V + block.x - 1) / block.x;
  const long long rows_a_step = static_cast<long long>(block.y) * rows_a_thread * BN_MIN_STEPS;
  const long long want = (m_rows + rows_a_step - 1) / rows_a_step;
  const long long ctas = static_cast<long long>(BN_CTAS_PER_SM) * sm_count();
  const long long cap = ctas / chunks > 0 ? ctas / chunks : 1;
  return dim3(chunks, static_cast<unsigned>(want < cap ? (want > 0 ? want : 1) : cap));
}

template <typename T, int MODE, int V>
int bn_act_run(const void* x, const void* s, const void* b, void* out, int m_rows, int ld, int c_live,
               int c_out, const void* bnd, int g, int relu, cudaStream_t stream) {
  const dim3 block = bn_block(c_out, V, BN_CW_ARITH);
  bn_act_kernel<T, MODE, V><<<bn_grid(m_rows, c_out, V, block, 16 / V), block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<int8_t*>(out), m_rows, ld, c_live, c_out, static_cast<const float*>(bnd), g, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int bn_act_width(const void* x, const void* s, const void* b, void* out, int m_rows, int ld, int c_live,
                 int c_out, const void* bnd, int g, int relu, cudaStream_t stream) {
  if (c_out % 8 == 0) return bn_act_run<T, MODE, 8>(x, s, b, out, m_rows, ld, c_live, c_out, bnd, g, relu, stream);
  return bn_act_run<T, MODE, 4>(x, s, b, out, m_rows, ld, c_live, c_out, bnd, g, relu, stream);
}

template <typename T>
int bn_act_dispatch(int mode, const void* x, const void* s, const void* b, void* out, int m_rows, int ld,
                    int c_live, int c_out, const void* bnd, int g, int relu, cudaStream_t stream) {
  switch (mode) {
    case POLY: return bn_act_width<T, POLY>(x, s, b, out, m_rows, ld, c_live, c_out, bnd, g, relu, stream);
    case ERF: return bn_act_width<T, ERF>(x, s, b, out, m_rows, ld, c_live, c_out, bnd, g, relu, stream);
    case BINS: return bn_act_width<T, BINS>(x, s, b, out, m_rows, ld, c_live, c_out, bnd, g, relu, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bn_args_ok(long long m_rows, int ld, int c_live, int c_out) {
  return m_rows < (1LL << 30) && ld % 4 == 0 && c_live % 4 == 0 && c_out % 4 == 0 && c_live <= ld &&
         c_live <= c_out && c_live > 0;
}

}  // namespace

extern "C" int bn_act_launch(const void* x, int x_is_int8, const void* s, const void* b, void* out,
                             long long m_rows, int ld, int c_live, int c_out, int mode, const void* bnd, int g,
                             int relu, void* stream) {
  if (!bn_args_ok(m_rows, ld, c_live, c_out)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(m_rows);
  if (x_is_int8) return bn_act_dispatch<int8_t>(mode, x, s, b, out, m, ld, c_live, c_out, bnd, g, relu, st);
  return bn_act_dispatch<float>(mode, x, s, b, out, m, ld, c_live, c_out, bnd, g, relu, st);
}

extern "C" int bn_table_launch(const void* x, const void* table, int tab_ld, void* out, long long m_rows, int ld,
                               int c_live, int c_out, void* stream) {
  if (!bn_args_ok(m_rows, ld, c_live, c_out) || tab_ld % TB_CH || tab_ld < c_live)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = static_cast<int>(m_rows), chunks = (c_out + TB_CH - 1) / TB_CH;
  const int want = (m + TB_ROWS * TB_U * BN_MIN_STEPS - 1) / (TB_ROWS * TB_U * BN_MIN_STEPS);
  const int cap = TB_CTAS_PER_SM * sm_count() / chunks;
  const dim3 grid(chunks, want < cap ? want : (cap > 0 ? cap : 1)), block(32, TB_ROWS);
  bn_table_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(table), tab_ld, static_cast<int8_t*>(out), m, ld,
      c_live, c_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cdf_quant_launch(const void* x, void* out, long long n, void* stream) {
  const long long n4 = (n >> 2) > 0 ? (n >> 2) : 1;
  const long long want = (n4 + THREADS - 1) / THREADS;
  const int ctas = static_cast<int>(want < MAX_CTAS ? want : MAX_CTAS);
  cdf_quant_kernel<<<ctas, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
