// The Hopper primitives the port's sm_90a kernels share (qmatmul_sm90.cu,
// qmatmul_sm90n.cu, qmatmul_sm90p.cu, stage_kernel_sm90.cu, stem_sm90.cu,
// bn_table_sm90.cu, digit_sm90.cu, first_conv_sm90.cu): mbarriers, TMA's
// 2-D and 3-D box loads, the 1-D bulk copy in and out, the async proxy's
// fence, wgmma with A from registers or by a descriptor and B by a
// shared-memory descriptor under a 32-, 64- or 128-byte swizzle (A's
// without one, at any strides), and the CUDA driver's tensor-map encoder,
// reached through cudaGetDriverEntryPoint so that no source links -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// wait for the phase of the given parity to complete; a wait of seconds
// means a lost arrival, and traps (the launch fails) rather than hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------ TMA

// a box of map at (c0, c1) into dst, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// a box of a 3-D map at (c0, c1, c2) into dst, completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// one arrival on bar (no transaction bytes)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes of global memory into dst
// (both 16-byte aligned), completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// `bytes` (a multiple of 16) of shared memory src to global dst (both
// 16-byte aligned), in this thread's bulk group; the writes to src before
// it must be made visible to the async proxy first (fence_proxy_async,
// then a barrier where other threads wrote)
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_u32(src)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// until every bulk store this thread committed has read its source
__device__ __forceinline__ void bulk_wait_read0() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// until every bulk store this thread committed is done
__device__ __forceinline__ void bulk_wait0() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// this thread's writes to shared memory made visible to the async proxy
// (bulk copies, TMA, wgmma's operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------ wgmma

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps a register that an in-flight wgmma reads or writes where it is
// until this point (the compiler cannot see the asynchronous access)
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// The descriptor of a K-major operand in shared memory under a swz-byte
// swizzle (128, 64 or 32): rows of swz bytes, 8-row core matrices 8 * swz
// bytes apart (the stride byte offset); the leading byte offset is unused
// for a swizzled K-major layout.
__device__ __forceinline__ uint64_t make_desc(const void* p, int swz) {
  const uint32_t addr = smem_u32(p);
  const uint64_t layout = swz == 128 ? 1 : (swz == 64 ? 2 : 3);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * swz) >> 4) << 32) | (layout << 62);
}

// The descriptor of a K-major operand in shared memory without swizzle:
// core matrices of 8 rows by 16 bytes, each 128 contiguous bytes, the next
// 8 rows 128 bytes on (the stride byte offset), the K step's second 16
// bytes lbo bytes on (the leading byte offset)
__device__ __forceinline__ uint64_t make_desc_plain(const void* p, uint32_t lbo) {
  const uint32_t addr = smem_u32(p);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// The descriptor of a K-major operand in shared memory without swizzle at
// any strides: core matrices of 8 rows by 16 bytes, rows 16 bytes apart,
// the next 8 rows sbo bytes on, the K step's second 16 bytes lbo bytes on
// (digit_sm90.cu's A: 8 neighbouring outputs of an image row, 16 bytes of
// one tap's channels each)
__device__ __forceinline__ uint64_t make_desc_strided(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = smem_u32(p);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

#define SM90_D4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define SM90_D16(i) SM90_D4(i), SM90_D4(i + 4), SM90_D4(i + 8), SM90_D4(i + 12)

// d (64 x NB int32, wgmma's accumulator layout) = A (64 x 32 s8, this
// warp's 16 rows in a) * B (32 x NB s8, by desc), plus d where add != 0,
// for NB = 16, 32 (K3, first_conv_sm90.cu), 24 (first_conv_sm90.cu), 64
// (both) and 128 (K1).
// The first product of a tile starts the sums by add = 0: an accumulator
// that another instruction writes would make ptxas serialize the wgmmas.
template <int NB>
__device__ __forceinline__ void wgmma_rs(int (&d)[NB / 2], const uint32_t (&a)[4], uint64_t desc, int add);

template <>
__device__ __forceinline__ void wgmma_rs<16>(int (&d)[8], const uint32_t (&a)[4], uint64_t desc, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : SM90_D4(0), SM90_D4(4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
}

template <>
__device__ __forceinline__ void wgmma_rs<24>(int (&d)[12], const uint32_t (&a)[4], uint64_t desc, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p;\n}\n"
      : SM90_D4(0), SM90_D4(4), SM90_D4(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(int (&d)[16], const uint32_t (&a)[4], uint64_t desc, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : SM90_D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(int (&d)[32], const uint32_t (&a)[4], uint64_t desc, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : SM90_D16(0), SM90_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(int (&d)[64], const uint32_t (&a)[4], uint64_t desc, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : SM90_D16(0), SM90_D16(16), SM90_D16(32), SM90_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
}

// d (64 x NB int32) = A (64 x 32 s8, by descriptor da) * B (32 x NB s8, by
// descriptor db), plus d where add != 0, for NB = 16, 32 and 64 (K1's
// narrow form) and 48 (digit_sm90.cu's conv2)
template <int NB>
__device__ __forceinline__ void wgmma_ss(int (&d)[NB / 2], uint64_t da, uint64_t db, int add);

template <>
__device__ __forceinline__ void wgmma_ss<16>(int (&d)[8], uint64_t da, uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : SM90_D4(0), SM90_D4(4)
      : "l"(da), "l"(db), "r"(add));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(int (&d)[16], uint64_t da, uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : SM90_D16(0)
      : "l"(da), "l"(db), "r"(add));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(int (&d)[24], uint64_t da, uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}\n"
      : SM90_D16(0), SM90_D4(16), SM90_D4(20)
      : "l"(da), "l"(db), "r"(add));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(int (&d)[32], uint64_t da, uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : SM90_D16(0), SM90_D16(16)
      : "l"(da), "l"(db), "r"(add));
}

// ------------------------------------------------------------ tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

}  // namespace sm90
