// Shared constants and helpers of the limb kernels.
//
// Limbs are 16-bit values held in 32-bit words (torch.int32 on the host,
// read here as uint32). Column sums accumulate in uint32 registers, as
// in the reference package's core/limbs.py: every column the kernels
// build stays below 2**32, so no sum wraps.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace limbs {

constexpr uint32_t kRadixBits = 16;
constexpr uint32_t kMask = 0xFFFFu;
// one thread per multiplication (row); rows of a block are neighbours
constexpr int kThreads = 128;

// A list of the widths (limbs) a kernel is compiled for, ascending, each
// list written once, beside what it belongs to: `dispatch(w, f)` calls
// the generic callable f with std::integral_constant<int, w> (so f
// instantiates its kernel at w) and returns its cudaError_t, or
// cudaErrorInvalidValue where w is not in the list.
template <int... W>
struct Widths {
  static constexpr bool contains(int w) { return ((w == W) || ...); }

  // the smallest width that holds n limbs, 0 where none does
  static constexpr int at_least(int n) {
    int got = 0;
    ((got = got != 0 ? got : n <= W ? W : 0), ...);
    return got;
  }

  template <class F>
  static cudaError_t dispatch(int w, F&& f) {
    cudaError_t err = cudaErrorInvalidValue;
    (void)((w == W && (err = f(std::integral_constant<int, W>{}), true)) ||
           ...);
    return err;
  }
};

// Widest operand (limbs) the kernels take: 384-bit operands, which hold
// BLS12-381's 381-bit field elements (kernels/_build.py MAX_LIMBS). Rows
// above 16 limbs take the wide arithmetic of row_tiles.cuh (`schoolbook`).
constexpr int kMaxLimbs = 24;

// The compiled widths of the per-thread kernels (kernels/_row_tiles.py
// `bucket`): a row of max(la, lb) limbs runs in the smallest that holds
// it, so every limb array lives in registers.
using Buckets = Widths<2, 4, 8, 16, 24>;
static_assert(Buckets::at_least(kMaxLimbs) == kMaxLimbs &&
                  Buckets::at_least(kMaxLimbs + 1) == 0,
              "the widest bucket is kMaxLimbs");

// The bucket of rows of (la, lb) limbs, 0 for rows wider than kMaxLimbs
// (which the launchers refuse).
inline int bucket(int la, int lb) {
  return Buckets::at_least(la > lb ? la : lb);
}

// f(std::integral_constant<int, bucket(la, lb)>), cudaErrorInvalidValue
// for rows wider than kMaxLimbs.
template <class F>
cudaError_t with_bucket(int la, int lb, F&& f) {
  return Buckets::dispatch(bucket(la, lb), f);
}

// Load `n` limbs of one row into a register array of MAXL, zero-filled.
template <int MAXL>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ src,
                                         int n, uint32_t (&dst)[MAXL]) {
#pragma unroll
  for (int k = 0; k < MAXL; ++k) dst[k] = k < n ? src[k] : 0u;
}

}  // namespace limbs
