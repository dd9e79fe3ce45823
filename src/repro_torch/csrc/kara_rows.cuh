// The row arithmetic of one-level Karatsuba, shared by the spatial
// Karatsuba (karatsuba_ppm.cu) and the folded one (mcim_fold.cu): a row
// of N limbs times a row of N limbs (N even) into 2N columns, carried to
// canonical limbs over the columns the caller keeps.
//
// KaraRows::product:
//   T0 = A0*B0 and T1 = A1*B1 on H = N/2 limbs, T2 = (A0+A1)*(B0+B1) on
//   H+1 limbs, each an exact product carried to its width (2H, 2H and
//   2H+2 limbs);
//   placement on 2N columns: +T0, +T1<<2H, +T2<<H keeping
//   min(2H+2, 2N-H) columns of T2 (at N = 2 T2's top column, always 0,
//   is dropped), and the two complements -(T0+T1)<<H as the columns
//   2*MASK - (t0+t1) in [H, 3H) and 2*MASK elsewhere (t0+t1 <= 2*MASK,
//   so no column's value wraps), plus 2 in column 0;
//   one carry pass over columns [0, n), the carry out dropped.
// The complements add 2 * 2**(32N) - 2 + 2 = 0 mod 2**(32N), so the
// columns hold A*B mod 2**(32N), and the carry pass over [0, n) gives
// A*B mod 2**(16n) for any n <= 2N.
// The three products take their 16x16 -> 32 limb products whole into
// 64-bit column sums, one wide multiply-add each (mad.wide.u32), where
// the TPU kernels split each into a low and a high half on two uint32
// columns (five operations); one carry pass then gives the same
// canonical limbs, since both are the exact product. The work is
// ordered so that few words are live at once: T0 is placed before T1 is
// computed, T1 before the sums, the sums' product last.
#pragma once

#include "row_tiles.cuh"

namespace kara {

using limbs::kMask;
using limbs::kRadixBits;

// t = x * y, L limbs each: the exact 2L-limb product. Limb products go
// whole into 2L-1 columns of 64-bit sums (each below L * 2**32), and one
// carry pass cuts them into canonical limbs; the top limb is the last
// carry (the product fits 2L limbs).
template <int L>
__device__ __forceinline__ void exact_product(const uint32_t (&x)[L],
                                              const uint32_t (&y)[L],
                                              uint32_t (&t)[2 * L]) {
  uint64_t col[2 * L - 1];
#pragma unroll
  for (int k = 0; k < 2 * L - 1; ++k) col[k] = 0u;
#pragma unroll
  for (int j = 0; j < L; ++j) {
#pragma unroll
    for (int i = 0; i < L; ++i) col[i + j] += (uint64_t)x[i] * y[j];
  }
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < 2 * L - 1; ++k) {
    const uint64_t tot = col[k] + carry;
    t[k] = (uint32_t)tot & kMask;
    carry = (uint32_t)(tot >> kRadixBits);
  }
  t[2 * L - 1] = carry;
}

// x0 + x1 of H limbs each, carried to H+1 limbs.
template <int H>
__device__ __forceinline__ void half_sum(const uint32_t* x,
                                         uint32_t (&s)[H + 1]) {
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const uint32_t tot = x[k] + x[H + k] + carry;
    s[k] = tot & kMask;
    carry = tot >> kRadixBits;
  }
  s[H] = carry;
}

// The row arithmetic of rows of N limbs, for tiles::coalesced_tile and
// tiles::bulk_walk. It keeps no tile state.
template <int N>
struct KaraRows {
  template <int M>
  __device__ __forceinline__ void weights(int, uint32_t (&w)[M]) const {
#pragma unroll
    for (int k = 0; k < M; ++k) w[k] = 0u;
  }
  template <int M>
  __device__ __forceinline__ void warp_weights(int inst,
                                               uint32_t (&w)[M]) const {
    weights(inst, w);
  }

  template <int M>
  __device__ __forceinline__ void product(const uint32_t (&a)[M],
                                          const uint32_t (&b)[M],
                                          const uint32_t (&)[M],
                                          uint32_t (&acc)[2 * M],
                                          int n) const {
    static_assert(M == N && N % 2 == 0, "rows of N limbs, N even");
    constexpr int H = N / 2, HP = H + 1, W = 2 * N;
    constexpr int kTake2 = 2 * HP < W - H ? 2 * HP : W - H;
    // -(T0 + T1)<<H as two complements: NOT is MASK minus each placed
    // limb (2*MASK a column for both), +1 +1 in column 0; the column sums
    // below are taken mod 2**32, and each column's value fits
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = 2 * kMask;
    acc[0] += 2u;
    {
      uint32_t x[H], y[H], t[2 * H];
#pragma unroll
      for (int k = 0; k < H; ++k) {
        x[k] = a[k];
        y[k] = b[k];
      }
      exact_product<H>(x, y, t);   // T0
#pragma unroll
      for (int c = 0; c < 2 * H; ++c) {
        acc[c] += t[c];
        acc[H + c] -= t[c];
      }
    }
    {
      uint32_t x[H], y[H], t[2 * H];
#pragma unroll
      for (int k = 0; k < H; ++k) {
        x[k] = a[H + k];
        y[k] = b[H + k];
      }
      exact_product<H>(x, y, t);   // T1
#pragma unroll
      for (int c = 0; c < 2 * H; ++c) {
        acc[2 * H + c] += t[c];
        acc[H + c] -= t[c];
      }
    }
    {
      uint32_t sa[HP], sb[HP], t[2 * HP];
      half_sum<H>(a, sa);
      half_sum<H>(b, sb);
      exact_product<HP>(sa, sb, t);  // T2
#pragma unroll
      for (int c = 0; c < kTake2; ++c) acc[H + c] += t[c];
    }
    tiles::carry_pass<W>(acc, n);
  }
};

}  // namespace kara
