// Combinational (spatial) one-level Karatsuba multiply, paper Fig. 4.
//
// Replaces the reference package's kernels/karatsuba_ppm/kernel.py
// _kara_kernel (:46), launched by karatsuba_ppm_mul (:86, pallas_call
// :97): (B, N) x (B, N) -> (B, 2N) canonical limbs, N even.
//
// Same arithmetic as the TPU kernel: T0, T1 and T2 as exact products,
// placed with the complements on 2N columns and carried once
// (kara_rows.cuh, KaraRows::product, shared with the folded Karatsuba of
// mcim_fold.cu).
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
// path cannot take returns cudaErrorInvalidValue.
//
// Bound: a row moves 16N bytes. With one wide multiply-add a limb
// product a row issues about 2(2H^2 + (H+1)^2) + 16H + 8N operations
// (848 at N = 16), so bytes bind at every N.
#include "kara_rows.cuh"

namespace {

using kara::KaraRows;

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
