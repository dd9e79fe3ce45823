// Shared constants and helpers of the limb kernels.
//
// Limbs are 16-bit values held in 32-bit words (torch.int32 on the host,
// read here as uint32). Column sums accumulate in uint32 registers, as
// in the reference package's core/limbs.py: every column the kernels
// build stays below 2**32, so no sum wraps.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace limbs {

constexpr uint32_t kRadixBits = 16;
constexpr uint32_t kMask = 0xFFFFu;
// one thread per multiplication (row); rows of a block are neighbours
constexpr int kThreads = 128;

// Smallest compiled operand width (limbs) that holds max(la, lb): the
// kernels are templated on it so every limb array lives in registers.
inline int bucket(int la, int lb) {
  const int n = la > lb ? la : lb;
  return n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : 16;
}

// Load `n` limbs of one row into a register array of MAXL, zero-filled.
template <int MAXL>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ src,
                                         int n, uint32_t (&dst)[MAXL]) {
#pragma unroll
  for (int k = 0; k < MAXL; ++k) dst[k] = k < n ? src[k] : 0u;
}

}  // namespace limbs
