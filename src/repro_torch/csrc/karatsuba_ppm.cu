// Combinational (spatial) one-level Karatsuba multiply, paper Fig. 4.
//
// Replaces the reference package's kernels/karatsuba_ppm/kernel.py
// _kara_kernel (:46), launched by karatsuba_ppm_mul (:86, pallas_call
// :97): (B, N) x (B, N) -> (B, 2N) canonical limbs, N even.
//
// Same arithmetic as the TPU kernel, step for step (KaraRows::product):
//   T0 = A0*B0 and T1 = A1*B1 on H = N/2 limbs, T2 = (A0+A1)*(B0+B1) on
//   H+1 limbs, each an exact product carried to its width (2H, 2H and
//   2H+2 limbs);
//   placement on 2N columns: +T0, +T1<<2H, +T2<<H keeping
//   min(2H+2, 2N-H) columns of T2 (at N = 2 T2's top column, always 0,
//   is dropped), and the two complements -(T0+T1)<<H as the columns
//   2*MASK - (t0+t1) in [H, 3H) and 2*MASK elsewhere (t0+t1 <= 2*MASK,
//   so no column's value wraps), plus 2 in column 0;
//   one carry pass over the 2N columns, the carry out dropped.
// The three products take their 16x16 -> 32 limb products whole into
// 64-bit column sums, one wide multiply-add each (mad.wide.u32), where
// the TPU kernel splits each into a low and a high half on two uint32
// columns (five operations); one carry pass then gives the same
// canonical limbs, since both are the exact product.
//
// Design. The TPU kernel runs a (tile, N) block per grid step. Here one
// thread owns one row, limbs in registers with compile-time indices (the
// kernels are templated on N), and the rows move as tiles
// (row_tiles.cuh). Every even N takes the per-thread path
// (coalesced_tile): one block a tile of 128 rows, each thread loading its
// row straight from device memory, products wider than 16 bytes stored
// through shared memory with neighbouring threads on neighbouring words.
// Only rows of 2 limbs with 16-byte-aligned spans take the bulk path (TMA
// bulk copies into a ring of shared stages on a persistent grid, each
// thread storing its 16-byte product). On the H100 the bulk walk beat the
// per-thread path at N = 2, won only warm at N = 4 (by 3.5%; 1% slower
// cold) and lost at N = 8 and 16, warm and cold, by 4% and 10% (PERF.md
// section 6): from 4 limbs a row is enough integer work that the
// per-thread path's many resident warps (up to 7 blocks an SM) hide the
// latency that the bulk walk's ring hides with fewer. The host picks the
// path (kernels/karatsuba_ppm/kernel.py `launch_plan`); a launch the bulk
// path cannot take returns cudaErrorInvalidValue. The work is ordered so
// that few words are live at once: T0 is placed before T1 is computed,
// T1 before the sums, the sums' product last.
//
// Bound: a row moves 16N bytes. With one wide multiply-add a limb
// product a row issues about 2(2H^2 + (H+1)^2) + 16H + 8N operations
// (848 at N = 16), so bytes bind at every N.
#include "row_tiles.cuh"

namespace {

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

// The bulk path, rows of 2 limbs.
__global__ void __launch_bounds__(tiles::Bulk<2>::kThreads)
    karatsuba_ppm_bulk_kernel(const uint32_t* __restrict__ a,
                              const uint32_t* __restrict__ b,
                              uint32_t* __restrict__ out, int bsz) {
  extern __shared__ __align__(128) uint8_t smem[];
  tiles::bulk_walk<2>(a, b, out, 1, bsz, smem, KaraRows<2>{});
}

template <int N>
__global__ void __launch_bounds__(tiles::kTileRows)
    karatsuba_ppm_kernel(const uint32_t* __restrict__ a,
                         const uint32_t* __restrict__ b,
                         uint32_t* __restrict__ out, int bsz) {
  extern __shared__ __align__(128) uint8_t smem[];
  tiles::coalesced_tile<N>(a, b, out, 0, blockIdx.x, bsz, N, N,
                           reinterpret_cast<uint32_t*>(smem),
                           KaraRows<N>{});
}

template <int N>
cudaError_t launch(const void* a, const void* b, void* out, int bsz,
                   void* stream) {
  const int T = tiles::kTileRows;  // at most 16,896 B: no attribute needed
  const size_t smem = N == 2 ? 0 : (size_t)T * tiles::pitch(2 * N) * 4;
  karatsuba_ppm_kernel<N><<<(bsz + T - 1) / T, T, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), bsz);
  return cudaGetLastError();
}

}  // namespace

// a, b: (bsz, n) limbs; out: (bsz, 2n) limbs; n even, 2 <= n <= 16; any
// 4-byte alignment.
extern "C" int karatsuba_ppm_launch(const void* a, const void* b, void* out,
                                    int bsz, int n, void* stream) {
  switch (n) {
    case 2: return launch<2>(a, b, out, bsz, stream);
    case 4: return launch<4>(a, b, out, bsz, stream);
    case 6: return launch<6>(a, b, out, bsz, stream);
    case 8: return launch<8>(a, b, out, bsz, stream);
    case 10: return launch<10>(a, b, out, bsz, stream);
    case 12: return launch<12>(a, b, out, bsz, stream);
    case 14: return launch<14>(a, b, out, bsz, stream);
    case 16: return launch<16>(a, b, out, bsz, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The bulk path: n = 2 limbs, 16-byte-aligned operands, bsz even.
extern "C" int karatsuba_ppm_bulk_launch(const void* a, const void* b,
                                         void* out, int bsz, int n,
                                         void* stream) {
  using B = tiles::Bulk<2>;
  if (n != 2 || bsz % 2 || !tiles::aligned16(a) || !tiles::aligned16(b) ||
      !tiles::aligned16(out)) {
    return cudaErrorInvalidValue;
  }
  int blocks = 0;
  cudaError_t err = tiles::resident_blocks(
      karatsuba_ppm_bulk_kernel, B::kThreads, B::kBytes, B::kPerSm, &blocks);
  if (err != cudaSuccess) return err;
  const int tiles_n = (bsz + B::kTileRows - 1) / B::kTileRows;
  karatsuba_ppm_bulk_kernel<<<tiles_n < blocks ? tiles_n : blocks,
                              B::kThreads, B::kBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), bsz);
  return cudaGetLastError();
}

// The bulk kernel's shape at n = 2 limbs on this device
// (tiles::bulk_shape).
extern "C" int karatsuba_ppm_bulk_shape(int n, int* info) {
  if (n != 2) return cudaErrorInvalidValue;
  return tiles::bulk_shape<2>(karatsuba_ppm_bulk_kernel, info);
}
