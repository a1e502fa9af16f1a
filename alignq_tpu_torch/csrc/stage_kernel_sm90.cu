// K3, its Hopper form: a run of stride-1 PreAct identity blocks on the
// int16 residual code stream, its convs on wgmma, its weights and planes
// moved by TMA, for sm_90a.
//
// Replaces the TPU kernel alignq_tpu/kernels/stage_kernel.py:171
// stage_identity_blocks (body _stage_body) at the shapes kernels/
// stage_kernel.py's planner (k3_plan) gives this form; stage_kernel.cu's
// mma.sync kernel keeps the others. It computes what that kernel computes:
// per block, on the integer code stream K >= 0, x8 = clip((2K+m)//(2m), 0,
// g); 3x3 conv; f32 scale/bias; poly act codes; relu; second 3x3 conv;
// codes; K = relu(a1 + K). The int32 sums are exact in any order and the
// epilogue is act_codes.cuh's poly_code, so the two forms agree bit for bit.
//
// What bounds it on an H100: the stream's bytes (the int16 plane read and
// written once a run) are below the epilogue's work, about 30 instructions
// a code, a third of them on the half-rate integer pipe (scale and bias,
// poly_code's clamp, seven Horner FMAs, rounding and clip, the residual
// add, relu and requant), which bit identity with the JAX graph fixes, and
// at C=16 below the A fragments' shared-memory loads (9 bytes a code); the
// int8 convs on the tensor cores are below both. It runs at 5-12x the byte
// bound (PERF.md, K3's Hopper form).
//
// What the design does about it:
// - A CTA holds a group of `imgs` images (the planner's chunk of images:
//   several where a plane is small, so that each staged weight serves
//   several m64 tiles) for all n blocks of the run. The group's int16 plane
//   ([pixel][C], as the stream lies in device memory) comes by TMA on an
//   mbarrier in boxes of BR pixels under a 2C-byte swizzle, and leaves the
//   same way: the residual epilogue's 4-byte accesses of 8 pixels a warp
//   (C/2 words apart) fall on distinct banks.
// - Each 3x3 conv is an implicit GEMM over a zero-bordered halo buffer
//   ([img][(H+2)(W+2)] pixels at a pitch P): M = the group's pixels in
//   m64 tiles, N = C, K = 9C padded to 32, one wgmma.mma_async m64nCk32
//   .s32.s8.s8 a K step. A comes from registers: lane t of a row reads its
//   8 bytes of a K step at the k-word table's offset (koff) in one load,
//   the weight's K permuted within each 32-byte step to match (as K1's
//   Hopper form; kernels/stage_kernel.py _k3_k_order). P (16, 32, 96 bytes
//   at C = 16, 32, 64) puts a half warp's 4 rows on distinct banks.
// - B, the weight [C_out][K], is re-packed once per tensor and comes by
//   TMA, a conv at a time, through a ring of two slots (boxes of SWZ bytes
//   of K by C rows under the matching swizzle, read by a descriptor): the
//   next conv's weight lands while the current one runs, so a run of any
//   length (ResNet-56's 8 blocks at C=64 hold 590 KB) streams.
// - A warpgroup loads a tile's A fragments at once and issues its K steps'
//   products back to back, one wait a tile; its epilogue overlaps the other
//   warpgroups' products (of this CTA and the SM's others). Keeping the
//   next tile's product in flight under the epilogue, or a K step at a time
//   on two A sets, ran slower (PERF.md, K3's Hopper form).
// - The block-edge requant is in the epilogue: the residual epilogue of
//   block b holds K_new = relu(a1 + K) in registers and writes both the
//   plane and block b+1's x8 into the halo buffer; block 0's is made as the
//   plane arrives. The division is an exact multiply-shift,
//   (2K+m)//(2m) = umulhi(2K+m, ceil(2^32/(2m))) for 0 <= 2K+m < 2^17
//   (kernels/stage_kernel.py requant_magic; tests/test_torch_k3_sm90.py
//   checks it for every K in [0, 32767] and m in 1..33).
//
// Rounding rule: every f32 `a * b + c` is one rounding (__fmaf_rn); the
// poly act codes are act_codes.cuh's poly_code, shared with K1 and with
// stage_kernel.cu.
//
// C interface: k3_sm90_launch takes the tensor map of the re-packed
// weight (k3_sm90_weight_map), encodes the two planes' own, and returns
// cudaGetLastError() after the launch (or the error that refused it). The
// Python wrapper checks the operands and computes the plan (k3_plan).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "act_codes.cuh"
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int MAX_BLOCKS = 32;

// The launch plan, in the order kernels/stage_kernel.py K3Plan lays it out.
struct Plan {
  int B, H, W, C, n_blocks, imgs, n_groups, n_wg, KP, SWZ, P, BR, w_slot, plane_bytes, halo_bytes, smem;
};
constexpr int PLAN_INTS = sizeof(Plan) / sizeof(int);

// Each block's requant multiplier m and its divisor's multiply-shift
// constant ceil(2^32 / (2 m)) (kernels/stage_kernel.py requant_magic)
struct Requant {
  int m[MAX_BLOCKS];
  uint32_t magic[MAX_BLOCKS];
};

template <int C>
struct Cfg {
  static constexpr int KP = (9 * C + 31) / 32 * 32;  // K padded to the wgmma depth
  static constexpr int KS = KP / 32;                  // K steps
  static constexpr int SWZ = KP % 128 == 0 ? 128 : (KP % 64 == 0 ? 64 : 32);
  static constexpr int P = C == 16 ? 16 : (C == 32 ? 32 : 96);
  static constexpr int NA = C / 2;                    // accumulators a thread
  static constexpr uint32_t PLANE_SWZ_MASK = static_cast<uint32_t>(2 * C / 16 - 1) << 4;
};

// The threads a CTA may have, which bounds the registers a thread: a
// warpgroup holds every K step's A fragments of a tile (20, 36 and 72
// registers at C = 16, 32 and 64) beside its accumulators (8, 16, 32), so
// at C=64 at most 2 warpgroups, up to 255 registers each.
template <int C>
constexpr int max_threads() {
  return C == 64 ? 256 : 512;
}

// ------------------------------------------------------------ TMA

// a box of src into map at (c0, c1); rows past the tensor are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

// ------------------------------------------------------------ the tiles

// a / d, by a shift where d is a power of two (dlog2 >= 0)
__device__ __forceinline__ int div_by(int a, int d, int dlog2) { return dlog2 >= 0 ? a >> dlog2 : a / d; }

// What a thread needs of its two rows r (h = 0: g, h = 1: g + 8) of a tile:
// the halo offset of the row's top-left tap (of the last row of the group
// where r is past it: read, never stored) and r itself.
struct Rows {
  int r[2];
  int halo[2];
};

template <int C>
__device__ __forceinline__ Rows rows_of(const Plan& p, int tile, int row0, int M, int wlog, int hwlog) {
  Rows rows;
  const int HW = p.H * p.W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = tile * 64 + row0 + 8 * h;
    const int rc = min(r, M - 1);
    const int img = div_by(rc, HW, hwlog), rem = rc - img * HW;
    const int y = div_by(rem, p.W, wlog), x = rem - y * p.W;
    rows.r[h] = r;
    rows.halo[h] = ((img * (p.H + 2) + y) * (p.W + 2) + x) * Cfg<C>::P;
  }
  return rows;
}

// A thread's entries of the k-word table, 4 ks + t for each K step ks: in
// registers at C <= 32 (loaded once a conv), read from shared memory at C
// = 64
template <int C>
struct Koff {
  static constexpr bool HELD = C <= 32;
  int v[HELD ? Cfg<C>::KS : 1];
  const int* table;
  int t;
  __device__ __forceinline__ Koff(const int* koff, int t_) : table(koff), t(t_) {
    if constexpr (HELD) {
#pragma unroll
      for (int ks = 0; ks < Cfg<C>::KS; ++ks) v[ks] = koff[4 * ks + t];
    }
  }
  __device__ __forceinline__ int operator[](int ks) const {
    if constexpr (HELD) return v[ks];
    return table[4 * ks + t];
  }
};

// The A fragments of every K step of a tile: lane t's 8 bytes of rows g
// and g + 8 (k = 8t..8t+7 of the step, the weight's K permuted to match)
template <int C>
__device__ __forceinline__ void load_a(uint32_t (&a)[Cfg<C>::KS][4], const unsigned char* xin, const Koff<C>& ko,
                                       int base0, int base1) {
#pragma unroll
  for (int ks = 0; ks < Cfg<C>::KS; ++ks) {
    const uint2 lo = *reinterpret_cast<const uint2*>(xin + base0 + ko[ks]);
    const uint2 hi = *reinterpret_cast<const uint2*>(xin + base1 + ko[ks]);
    a[ks][0] = lo.x;
    a[ks][2] = lo.y;
    a[ks][1] = hi.x;
    a[ks][3] = hi.y;
  }
}

// The product of a tile, every K step, into acc: one commit group
template <int C>
__device__ __forceinline__ void issue(int (&acc)[Cfg<C>::NA], uint32_t (&a)[Cfg<C>::KS][4], uint64_t desc0) {
  using K = Cfg<C>;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < K::KS; ++ks) {
    const int kb = 32 * ks;
    const uint64_t desc = desc0 + ((((kb / K::SWZ) * C * K::SWZ) + (kb % K::SWZ)) >> 4);
    wgmma_rs<C>(acc, a[ks], desc, ks > 0);
  }
  wgmma_commit();
}

template <int C>
__device__ __forceinline__ void settle(int (&acc)[Cfg<C>::NA], uint32_t (&a)[Cfg<C>::KS][4]) {
#pragma unroll
  for (int i = 0; i < Cfg<C>::NA; ++i) reg_fence(acc[i]);
#pragma unroll
  for (int ks = 0; ks < Cfg<C>::KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) reg_fence(a[ks][i]);
}

// x8 = clip((2K+m)//(2m), 0, g) by the block's multiply-shift; K >= 0
// where POS (the residual epilogue's relu'd K)
template <bool POS = false>
__device__ __forceinline__ int requant(int k, uint32_t magic, int m, int g) {
  const int n = POS ? 2 * k + m : max(2 * k + m, 0);  // floor and the clip at 0 agree below 0
  return min(static_cast<int>(__umulhi(static_cast<uint32_t>(n), magic)), g);
}

// act_codes.cuh's poly_code, relu'd where LO is 0: clip(rint(c * g), LO,
// g) by one rounding conversion (F2I.RN) in place of rintf and a
// truncating one, and an integer clip
template <int LO>
__device__ __forceinline__ int poly_code_rn(float h, float gf, int g) {
  return min(max(act::poly_code<true>(h, gf), LO == 0 ? 0 : -g), g);
}

// The accumulator as an f32, as the int -> f32 cast rounds it. At C=16
// |acc| <= 144 * 127 * 128 < 2^22 (codes in [0, 127], int8 weights), where
// 1.5 * 2^23 + acc is exact in the float's mantissa: an integer add and a
// float subtract in place of the quarter-rate I2F.
template <int C>
__device__ __forceinline__ float acc_f32(int acc) {
  if constexpr (C == 16) return __fsub_rn(__int_as_float(acc + 0x4B400000), 12582912.0f);
  return static_cast<float>(acc);
}

struct Epi {
  const float* scale;  // this conv's C scales and biases (in registers at C <= 32: Scales)
  const float* bias;
  float gf;
  int g;
  int interior;        // halo offset of a pixel from its top-left tap: (W + 3) * P
  // the residual conv: the plane and the next block's requant, if any
  unsigned char* plane;
  uint32_t magic;
  int m;
  bool requant_next;
};

// A thread's scales and biases of one conv, columns 8j + 2t and + 1: in
// registers at C <= 32 (loaded once a conv), read per tile at C = 64,
// where the registers are spent on the accumulators
template <int C>
struct Scales {
  static constexpr bool HELD = C <= 32;
  float2 s[HELD ? C / 8 : 1], b[HELD ? C / 8 : 1];
  __device__ __forceinline__ void load(const Epi& e, int t) {
    if constexpr (HELD) {
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        s[j] = __ldg(reinterpret_cast<const float2*>(e.scale + 8 * j + 2 * t));
        b[j] = __ldg(reinterpret_cast<const float2*>(e.bias + 8 * j + 2 * t));
      }
    }
  }
  __device__ __forceinline__ float2 scale(const Epi& e, int j, int t) const {
    if constexpr (HELD) return s[j];
    return __ldg(reinterpret_cast<const float2*>(e.scale + 8 * j + 2 * t));
  }
  __device__ __forceinline__ float2 bias(const Epi& e, int j, int t) const {
    if constexpr (HELD) return b[j];
    return __ldg(reinterpret_cast<const float2*>(e.bias + 8 * j + 2 * t));
  }
};

// Accumulator 4j + 2h + v: tile row g + 8h (of this warp's 16), column
// 8j + 2t + v.
// FIRST: relu(codes) into the halo buffer xout's interior.
// else : K = relu(codes + K) into the plane; x8 of K for the next block
//        into xout's interior.
template <int C, bool FIRST>
__device__ __forceinline__ void epilogue(const int (&acc)[Cfg<C>::NA], const Rows& rows, int M, int t,
                                         unsigned char* xout, const Epi& e, const Scales<C>& sb) {
  using K = Cfg<C>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rows.r[h];
    if (r >= M) continue;
    unsigned char* dst = xout + rows.halo[h] + e.interior;
    const uint32_t prow = static_cast<uint32_t>(r) * (2 * C);
    const uint32_t pswz = (prow >> 3) & K::PLANE_SWZ_MASK;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int co = 8 * j + 2 * t;
      const float2 s = sb.scale(e, j, t), b = sb.bias(e, j, t);
      const float h0 = __fmaf_rn(acc_f32<C>(acc[4 * j + 2 * h]), s.x, b.x);
      const float h1 = __fmaf_rn(acc_f32<C>(acc[4 * j + 2 * h + 1]), s.y, b.y);
      if (FIRST) {
        *reinterpret_cast<uint16_t*>(dst + co) =
            static_cast<uint16_t>(poly_code_rn<0>(h0, e.gf, e.g) | poly_code_rn<0>(h1, e.gf, e.g) << 8);
      } else {
        uint32_t* kp = reinterpret_cast<uint32_t*>(e.plane + prow + ((2u * co) ^ pswz));
        const uint32_t old = *kp;
        const int k0 = max(poly_code_rn<-1>(h0, e.gf, e.g) + static_cast<int>(static_cast<int16_t>(old & 0xffff)), 0);
        const int k1 = max(poly_code_rn<-1>(h1, e.gf, e.g) + (static_cast<int>(old) >> 16), 0);
        *kp = static_cast<uint32_t>(k0 & 0xffff) | static_cast<uint32_t>(k1) << 16;
        if (e.requant_next)
          *reinterpret_cast<uint16_t*>(dst + co) = static_cast<uint16_t>(
              requant<true>(k0, e.magic, e.m, e.g) | requant<true>(k1, e.magic, e.m, e.g) << 8);
      }
    }
  }
}

// One 3x3 pad-1 conv of the group (M pixels) over the halo buffer xin,
// the weight in slot ws: warpgroup wg takes tiles wg, wg + n_wg, ...; a
// tile's A fragments are loaded at once and its K steps' products issued
// back to back, one wait a tile. A tile's epilogue overlaps the other
// warpgroups' products.
template <int C, bool FIRST>
__device__ void conv3x3(const Plan& p, const unsigned char* xin, const unsigned char* ws, const int* koff, int M,
                        int wlog, int hwlog, unsigned char* xout, const Epi& e) {
  using K = Cfg<C>;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 16 * wq + g;
  const int n_tiles = (M + 63) >> 6;
  const uint64_t desc0 = make_desc(ws, K::SWZ);
  const Koff<C> ko(koff, t);
  Scales<C> sb;
  sb.load(e, t);
  int acc[K::NA];
  uint32_t a[K::KS][4];
  for (int tile = wg; tile < n_tiles; tile += p.n_wg) {
    const Rows rows = rows_of<C>(p, tile, row0, M, wlog, hwlog);
    load_a<C>(a, xin, ko, rows.halo[0], rows.halo[1]);
    issue<C>(acc, a, desc0);
    wgmma_wait<0>();
    settle<C>(acc, a);
    epilogue<C, FIRST>(acc, rows, M, t, xout, e, sb);
  }
}

// conv j's weight (rows j*C.. of the re-packed (2 n_blocks C, KP) weight)
// into slot ws, completing on bar (thread 0 only)
template <int C>
__device__ __forceinline__ void issue_weight(unsigned char* ws, const CUtensorMap* wmap, uint64_t* bar, int j) {
  using K = Cfg<C>;
  mbar_arrive_expect_tx(bar, C * K::KP);
#pragma unroll 1
  for (int a = 0; a < K::KP / K::SWZ; ++a) tma_load_2d(ws + a * C * K::SWZ, wmap, bar, a * K::SWZ, j * C);
}

template <int C>
__global__ void __launch_bounds__(max_threads<C>(), 1)
k3_sm90_kernel(const __grid_constant__ CUtensorMap in_map, const __grid_constant__ CUtensorMap out_map,
               const __grid_constant__ CUtensorMap wmap, const float* __restrict__ scale,
               const float* __restrict__ bias, const Plan p, const Requant rq, int g) {
  using K = Cfg<C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the plane (swizzled in 2C-byte rows) and the weight slots at a
  // 1024-byte boundary, the swizzles' largest period
  unsigned char* plane = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ws0 = plane + p.plane_bytes;
  unsigned char* ws1 = ws0 + p.w_slot;
  unsigned char* xa = ws1 + p.w_slot;
  unsigned char* xb = xa + p.halo_bytes;
  int* koff = reinterpret_cast<int*>(xb + p.halo_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(koff + K::KP / 8);  // plane, slot 0, slot 1
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int HW = p.H * p.W, Wp = p.W + 2;
  const int img0 = blockIdx.x * p.imgs;
  const int imgs_here = min(p.imgs, p.B - img0);
  const int M = imgs_here * HW;
  const int row_base = img0 * HW;  // the group's first pixel of the stream
  const int n_boxes = (M + p.BR - 1) / p.BR;
  const int n_convs = 2 * p.n_blocks;
  const int wlog = (p.W & (p.W - 1)) == 0 ? __ffs(p.W) - 1 : -1;
  const int hwlog = (HW & (HW - 1)) == 0 ? __ffs(HW) - 1 : -1;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(bars, n_boxes * p.BR * 2 * C);
    for (int i = 0; i < n_boxes; ++i) tma_load_2d(plane + i * p.BR * 2 * C, &in_map, bars, 0, row_base + i * p.BR);
    issue_weight<C>(ws0, &wmap, bars + 1, 0);
    issue_weight<C>(ws1, &wmap, bars + 2, 1);
  }
  // the halo buffers: zero once, only their interiors are written below
  for (int i = tid; i < 2 * p.halo_bytes / 16; i += nthr) reinterpret_cast<int4*>(xa)[i] = make_int4(0, 0, 0, 0);
  // entry q: k = 8q, tap k / C, channel k % C; K's zero-weight tail reads
  // the last tap
  for (int q = tid; q < K::KP / 8; q += nthr) {
    const int k = 8 * q, tap = k / C, c = k - tap * C;
    koff[q] = tap < 9 ? ((tap / 3) * Wp + tap % 3) * K::P + c : (2 * Wp + 2) * K::P;
  }
  __syncthreads();

  // block 0's requant as the plane arrives: 8 channels of a pixel at a time
  mbar_wait(bars, 0);
  {
    const int m = rq.m[0];
    const uint32_t mg = rq.magic[0];
    for (int i = tid; i < M * (C / 8); i += nthr) {
      const int r = i / (C / 8), u = i - r * (C / 8);
      const uint32_t prow = static_cast<uint32_t>(r) * (2 * C);
      const int4 v = *reinterpret_cast<const int4*>(plane + prow + ((16u * u) ^ ((prow >> 3) & K::PLANE_SWZ_MASK)));
      const int pairs[4] = {v.x, v.y, v.z, v.w};  // 2 int16 codes each, low half first
      uint32_t words[2] = {0, 0};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = static_cast<int16_t>(pairs[e >> 1] >> (16 * (e & 1)));
        words[e >> 2] |= static_cast<uint32_t>(requant(k, mg, m, g)) << (8 * (e & 3));
      }
      const int img = div_by(r, HW, hwlog), rem = r - img * HW;
      const int y = div_by(rem, p.W, wlog), x = rem - y * p.W;
      *reinterpret_cast<uint2*>(xa + ((img * (p.H + 2) + y + 1) * Wp + x + 1) * K::P + 8 * u) =
          make_uint2(words[0], words[1]);
    }
  }
  __syncthreads();

  Epi e;
  e.gf = static_cast<float>(g);
  e.g = g;
  e.interior = (Wp + 1) * K::P;
  e.plane = plane;
  for (int b = 0; b < p.n_blocks; ++b) {
    // conv0: xa -> xb
    mbar_wait(bars + 1, b & 1);
    e.scale = scale + 2 * b * C;
    e.bias = bias + 2 * b * C;
    conv3x3<C, true>(p, xa, ws0, koff, M, wlog, hwlog, xb, e);
    __syncthreads();  // xb whole; slot 0 read
    if (tid == 0 && 2 * b + 2 < n_convs) issue_weight<C>(ws0, &wmap, bars + 1, 2 * b + 2);
    // conv1: xb -> the plane, and block b + 1's x8 -> xa
    mbar_wait(bars + 2, b & 1);
    e.scale = scale + (2 * b + 1) * C;
    e.bias = bias + (2 * b + 1) * C;
    e.requant_next = b + 1 < p.n_blocks;
    e.m = e.requant_next ? rq.m[b + 1] : 1;
    e.magic = e.requant_next ? rq.magic[b + 1] : 0u;
    conv3x3<C, false>(p, xb, ws1, koff, M, wlog, hwlog, xa, e);
    if (b + 1 == p.n_blocks) fence_proxy_async();  // the plane's last writes, before the TMA store reads it
    __syncthreads();  // xa and the plane whole; slot 1 read
    if (tid == 0 && 2 * b + 3 < n_convs) issue_weight<C>(ws1, &wmap, bars + 2, 2 * b + 3);
  }

  if (tid == 0) {
    for (int i = 0; i < n_boxes; ++i) tma_store_2d(&out_map, plane + i * p.BR * 2 * C, 0, row_base + i * p.BR);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ------------------------------------------------------------ tensor maps

CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

// The 2-D map of a row-major (rows, width) int8 matrix at ptr, in boxes of
// box_w bytes by box_rows rows under a box_w-byte swizzle
int encode_2d(CUtensorMap* map, const void* ptr, uint64_t width, uint64_t rows, int box_w, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {width, rows};
  const cuuint64_t strides[1] = {width};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
                              elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(box_w),
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int C>
int launch(const CUtensorMap& in_map, const CUtensorMap& out_map, const CUtensorMap& wmap, const void* scale,
           const void* bias, const Plan& p, const Requant& rq, int g, cudaStream_t stream) {
  auto kernel = k3_sm90_kernel<C>;
  if (128 * p.n_wg > max_threads<C>()) return static_cast<int>(cudaErrorInvalidValue);
  static int smem_allowed = 48 * 1024;
  if (p.smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = p.smem;
  }
  kernel<<<p.n_groups, 128 * p.n_wg, p.smem, stream>>>(in_map, out_map, wmap, static_cast<const float*>(scale),
                                                       static_cast<const float*>(bias), p, rq, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int k3_sm90_plan_ints() { return PLAN_INTS; }

extern "C" int k3_sm90_map_bytes() { return static_cast<int>(sizeof(CUtensorMap)); }

// The tensor map of a re-packed weight wt (rows, kp) int8, rows = 2
// n_blocks C, in boxes of swz bytes of K by c rows under the matching
// swizzle, into map_out (host memory of k3_sm90_map_bytes()): the caller
// keeps it beside the re-packed weight, for as long as that lives.
extern "C" int k3_sm90_weight_map(const void* wt, int kp, int rows, int swz, int c, void* map_out) {
  if ((swz != 128 && swz != 64 && swz != 32) || (c != 16 && c != 32 && c != 64) || kp % swz || rows % c)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const int err = encode_2d(&map, wt, static_cast<uint64_t>(kp), static_cast<uint64_t>(rows), swz, c);
  if (err != 0) return err;
  memcpy(map_out, &map, sizeof(map));
  return 0;
}

// K3's Hopper form on the (B*H*W, C) int16 streams in and out (16-byte
// aligned): the weight's map, scale and bias (2 n_blocks, C) f32, the plan,
// each block's multiplier m and its constant ceil(2^32 / (2m)), and g.
extern "C" int k3_sm90_launch(const void* in, void* out, const void* wmap, const void* scale, const void* bias,
                              const int* plan, const int* ms, const unsigned* magic, int g, void* stream) {
  Plan p;
  memcpy(&p, plan, sizeof(p));
  if (p.n_blocks < 1 || p.n_blocks > MAX_BLOCKS || p.n_wg < 1 || p.BR < 1 || p.BR > 256 || p.n_groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Requant rq{};
  for (int i = 0; i < p.n_blocks; ++i) {
    if (ms[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    rq.m[i] = ms[i];
    rq.magic[i] = magic[i];
  }
  const uint64_t rows = static_cast<uint64_t>(p.B) * p.H * p.W;
  CUtensorMap in_map, out_map, w;
  int err = encode_2d(&in_map, in, 2 * p.C, rows, 2 * p.C, p.BR);
  if (err == 0) err = encode_2d(&out_map, out, 2 * p.C, rows, 2 * p.C, p.BR);
  if (err != 0) return err;
  memcpy(&w, wmap, sizeof(w));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.C) {
    case 16: return launch<16>(in_map, out_map, w, scale, bias, p, rq, g, s);
    case 32: return launch<32>(in_map, out_map, w, scale, bias, p, rq, g, s);
    case 64: return launch<64>(in_map, out_map, w, scale, bias, p, rq, g, s);
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
