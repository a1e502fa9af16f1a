// K2 for Hopper: CDF-alignment quantization of f32 to int8 codes through a
// step table of its map, for sm_90a.
//
// Replaces the TPU kernel alignq_tpu/kernels/quantize.py:57
// cdf_quantize_int8 (body _cdf_quant_kernel): q = clip(round(erf(x /
// sqrt2) * 127), +-127), erf by Abramowitz-Stegun 7.1.26, elementwise over
// f32 of any shape. It computes what quantize.cu's cdf_quant_kernel (the
// direct map, act_codes.cuh as_code) computes, bit for bit on every f32
// pattern (chip_smoke.py checks all 2^32 on the card, in every form).
//
// What bounds it on an H100: bytes, 4 in and 1 out an element (0.0110 ms
// over the three act-site sizes of a batch of 256, 0.0876 at 2048). What
// held the direct kernel back (PERF.md): ~45 issue slots an element for the
// map (an IEEE division and a full-precision expf, each a MUFU operation
// with its correction, and the Horner steps), as many as the bytes take at
// batch 256, and one 16-byte load a thread in flight, then the map with
// nothing in flight.
//
// What the design does about it:
// - The map through its step table (kernels/quantize.py k2_table): floor(x
//   * 128 + 512), one rounding, is x's bucket of 1/128, which holds at most
//   one step of the code, and its entry {the code below the step, the
//   step} gives the code by one compare. The table holds every bucket, the
//   end codes past the steps, so no select at its ends is needed: ~12
//   operations and a shared-memory load a code. The f32 map may be
//   non-monotone in a few ulps at a step; entries carry such windows
//   (act_codes.cuh in_window), every code is tested for one, and the map's
//   own code taken there, out of line. On the H100 the table has none; a
//   copy without the test (k2_split.py's nowindows) measured 1.7% faster at
//   the batch-256 sizes and 0.5% slower at 2048, so one form serves any
//   table. The table is built on the card from the direct kernel's own
//   codes (its bisection and window scan are launches of cdf_quant_kernel):
//   the card's expf differs from the CPU's in its last bit, and the card's
//   table differs from the CPU-built one at 46 of its 254 steps, by a few
//   ulps each (chip_smoke.py --k2-ab). NaN gives 0, as the direct map's
//   sign select gives it.
// - Persistent CTAs, one wave (SMs x the CTAs an SM holds, by the
//   occupancy calculator; 5 of 256 threads); each copies the table (8 KB)
//   into shared memory once, its loads issued beside the first tile's, and
//   walks tiles of 4096 elements, 16 a thread a step: four 16-byte
//   streaming loads, each a warp's 512 contiguous bytes (quad lane + 32 j
//   of the warp's 512 elements), issued before any lookup, and the next
//   tile's four in flight under this tile's codes (PIPE); the codes go out
//   in four 4-byte stores of 128 contiguous bytes a warp.
// - Two alternatives were measured as edited copies of this source
//   (k2_split.py): fold, a table of |x| (the map is odd) with x's sign put
//   back, half the table and a few more operations a code, a tie; contig,
//   a thread's 16 elements consecutive and one 16-byte store of their
//   codes, whose loads each touch half of every sector, slower.
// - The ragged tail (n mod 16, or a thread's partial quads) is masked in
//   the last tile: element by element, the table's codes all the same.
//   The input must start 16-byte aligned; the wrapper copies a view that
//   does not (kernels/quantize.py cdf_quantize_int8): such views are rare,
//   and one aligned path keeps the loads and stores whole.
// - Below 2^19 elements the direct kernel is faster (the table's copy and
//   the larger code are a fixed cost of ~0.2 us a launch there), and the
//   entry point gives it those sizes (kernels/quantize.py k2_takes).
//
// C interface: cdf_quant_sm90_launch returns cudaGetLastError() after the
// launch, or the error that refused it; cdf_quant_sm90_per_sm gives the
// CTAs an SM holds. The wrapper (kernels/quantize.py) checks the operands
// and computes the plan (k2_plan: the grid).

#include <cuda_runtime.h>
#include <stdint.h>

#include "act_codes.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;              // elements a thread a step: four 16-byte loads
constexpr int TILE = THREADS * PER_THREAD;  // elements a CTA a step
// PIPE: the next tile's loads in flight under this tile's codes (faster at
// the batch-256 sizes than without, k2_split.py's nopipe variant)
constexpr bool PIPE = true;
constexpr int N_TAB = act::BUCKETS;  // the table's entries: every bucket of [-4, 4)
constexpr int QSTEP = 128;           // the offset of a thread's quad j from its quad j - 1

// K2's codes of N values through the table (tab in shared memory): the N
// lookups first, then one rarely taken branch for those in a window, then
// NaN's 0
template <int N>
__device__ __forceinline__ void k2_codes(const float (&x)[N], int (&code)[N], const int2* __restrict__ tab) {
  int2 e[N];
#pragma unroll
  for (int j = 0; j < N; ++j) e[j] = act::table_entry(x[j], tab, 0, N_TAB);
  unsigned in = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    code[j] = (e[j].x & 0xffff) - 127 + (x[j] >= __int_as_float(e[j].y));
    in |= static_cast<unsigned>(act::in_window(x[j], e[j])) << j;
  }
  if (in)
    for (int j = 0; j < N; ++j)
      if ((in >> j) & 1) code[j] = act::window_code<act::AS, false>(x[j], 127);
#pragma unroll
  for (int j = 0; j < N; ++j) code[j] = x[j] == x[j] ? code[j] : 0;
}

// the codes of four values as a word, and of one value (the ragged tail)
__device__ __forceinline__ uint32_t code_word(const float4 v, const int2* __restrict__ tab) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  int c[4];
  k2_codes<4>(x, c, tab);
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) word |= (static_cast<uint32_t>(c[j]) & 0xff) << (8 * j);
  return word;
}

__device__ __noinline__ int8_t code_one(float v, const int2* __restrict__ tab) {
  const float x[1] = {v};
  int c[1];
  k2_codes<1>(x, c, tab);
  return static_cast<int8_t>(c[0]);
}

// A thread's 16 elements from e0: quad j at e0 + j QSTEP. Their four
// loads, where all 16 lie before n (else none: the tile's ragged part)
__device__ __forceinline__ bool load16(const float* __restrict__ x, long long n, long long e0, float4 (&v)[4]) {
  if (e0 + 3 * QSTEP + 4 > n) return false;
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __ldcs(reinterpret_cast<const float4*>(x + e0 + j * QSTEP));
  return true;
}

// ... their codes and stores (full: as loaded; else element by element)
__device__ __forceinline__ void codes16(const float* __restrict__ x, int8_t* __restrict__ out, long long n,
                                        long long e0, bool full, const float4 (&v)[4],
                                        const int2* __restrict__ tab) {
  if (full) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = code_word(v[j], tab);
#pragma unroll
    for (int j = 0; j < 4; ++j) *reinterpret_cast<uint32_t*>(out + e0 + j * QSTEP) = w[j];
  } else {
    for (int j = 0; j < 4; ++j)
      for (int k = 0; k < 4; ++k) {
        const long long e = e0 + j * QSTEP + k;
        if (e < n) out[e] = code_one(x[e], tab);
      }
  }
}

__global__ void __launch_bounds__(THREADS)
cdf_quant_sm90_kernel(const float* __restrict__ x, int8_t* __restrict__ out, long long n,
                      const int2* __restrict__ table) {
  __shared__ int2 tab[N_TAB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long off = 512 * warp + 4 * lane;  // a thread's first element in a tile
  const long long tiles = (n + TILE - 1) / TILE;
  long long tile = blockIdx.x;  // < tiles: the grid is at most one CTA a tile
  // the first tile's loads and the table's go out together; the table
  // reaches shared memory once they are all in flight
  float4 v[4];
  bool full = load16(x, n, tile * TILE + off, v);
  int2 te[N_TAB / THREADS];
#pragma unroll
  for (int k = 0; k < N_TAB / THREADS; ++k) te[k] = table[threadIdx.x + k * THREADS];
#pragma unroll
  for (int k = 0; k < N_TAB / THREADS; ++k) tab[threadIdx.x + k * THREADS] = te[k];
  __syncthreads();
  for (;;) {
    const long long next = tile + gridDim.x;
    float4 nv[4];
    bool next_full = false;
    if (PIPE && next < tiles) next_full = load16(x, n, next * TILE + off, nv);  // in flight under the codes
    codes16(x, out, n, tile * TILE + off, full, v, tab);
    if (next >= tiles) break;
    tile = next;
    if (PIPE) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = nv[j];
      full = next_full;
    } else {
      full = load16(x, n, tile * TILE + off, v);
    }
  }
}

}  // namespace

// The CTAs an SM holds at once (a negative CUDA error where the query
// failed)
extern "C" int cdf_quant_sm90_per_sm() {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cdf_quant_sm90_kernel, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// x (n,) f32 into out (n,) int8 codes, both 16-byte aligned, on ctas (at
// most one a tile) persistent CTAs; table: the n_entries entries of K2's
// table (kernels/quantize.py k2_table), every bucket of [-4, 4)
extern "C" int cdf_quant_sm90_launch(const void* x, void* out, long long n, int ctas, const void* table,
                                     int n_entries, void* stream) {
  if (n < 1 || ctas < 1 || ctas > (n + TILE - 1) / TILE || n_entries != N_TAB ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(table) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cdf_quant_sm90_kernel<<<ctas, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(out), n, static_cast<const int2*>(table));
  return static_cast<int>(cudaGetLastError());
}
