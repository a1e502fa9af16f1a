// The depthwise forms' tap arithmetic, shared by dwconv.cu (K1's depthwise
// form) and dwconv_sm90.cu (its Hopper form), so that both sum the same
// 9 taps by the same instructions: a band column of a channel quad's 3
// row words, transposed by __byte_perm into one word a channel, and one
// __dp4a a (column, channel) against the likewise-transposed weights.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dw {

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The 3 row words (r0, r1, r2) of a column of one channel quad, transposed:
// t[j] holds channel j's bytes (r0.j, r1.j, r2.j, r0.j); the 4th byte
// meets a zero weight byte.
__device__ __forceinline__ void transpose3(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t (&t)[4]) {
  const uint32_t lo = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t hi = __byte_perm(r0, r1, 0x7362);  // r0.2 r1.2 r0.3 r1.3
  t[0] = __byte_perm(lo, r2, 0x0410);
  t[1] = __byte_perm(lo, r2, 0x2532);
  t[2] = __byte_perm(hi, r2, 0x0610);
  t[3] = __byte_perm(hi, r2, 0x2732);
}

// One band column of a thread's quad and output row: its 3 row words,
// transposed
struct Col {
  uint32_t v[4];
};

__device__ __forceinline__ Col load_col(const unsigned char* p, int rp) {
  Col col;
  transpose3(lds32(p), lds32(p + rp), lds32(p + 2 * rp), col.v);
  return col;
}

// The weights of a thread's quad as the tap sums take them: per column dx
// and channel j the word (w[0][dx].j, w[1][dx].j, w[2][dx].j, 0)
struct QuadWeights {
  int v[3 * 4];
};

__device__ __forceinline__ QuadWeights load_weights(const int8_t* __restrict__ w, int C, int c) {
  const uint32_t* w4 = reinterpret_cast<const uint32_t*>(w);
  const int quads = C / 4, q = c / 4;
  QuadWeights qw;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    uint32_t t[4];
    transpose3(__ldg(w4 + dx * quads + q), __ldg(w4 + (3 + dx) * quads + q), __ldg(w4 + (6 + dx) * quads + q), t);
#pragma unroll
    for (int j = 0; j < 4; ++j) qw.v[dx * 4 + j] = static_cast<int>(t[j] & 0x00ffffffu);
  }
  return qw;
}

// The 4 channels' sums over the 9 taps of the window (columns a, b, c):
// one dp4a a column and channel
__device__ __forceinline__ void tap_sums(const Col& a, const Col& b, const Col& c, const QuadWeights& qw,
                                         int (&acc)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int s = __dp4a(static_cast<int>(a.v[j]), qw.v[j], 0);
    s = __dp4a(static_cast<int>(b.v[j]), qw.v[4 + j], s);
    acc[j] = __dp4a(static_cast<int>(c.v[j]), qw.v[8 + j], s);
  }
}

}  // namespace dw
