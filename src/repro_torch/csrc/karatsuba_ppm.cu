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
  int info[4];
  tiles::tile_launch_shape(N, 1, bsz, N, N, info);
  karatsuba_ppm_kernel<N><<<info[0], info[2], info[3],
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), bsz);
  return cudaGetLastError();
}

// The bulk launch: rows of 2 limbs (tiles::bulk_launch_shape).
cudaError_t bulk_launch_at(int bsz, int n, int* info) {
  if (n != 2) return cudaErrorInvalidValue;
  return tiles::bulk_launch_shape<2>(karatsuba_ppm_bulk_kernel, 1, bsz, info);
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
  if (!tiles::aligned16(a) || !tiles::aligned16(b) ||
      !tiles::aligned16(out)) {
    return cudaErrorInvalidValue;
  }
  int info[4];
  const cudaError_t err = bulk_launch_at(bsz, n, info);
  if (err != cudaSuccess) return err;
  karatsuba_ppm_bulk_kernel<<<info[0], info[2], info[3],
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

// The launch each entry above makes for these arguments, and the
// attributes of the kernel it launches: info = {grid.x, grid.y, threads,
// dynamic shared bytes} and {registers, local bytes, static shared
// bytes, most threads a block} (the launch contract of
// kernels/karatsuba_ppm/ops.py is held to them).
extern "C" int karatsuba_ppm_launch_shape(int bsz, int n, int* info) {
  if (n < 2 || n > 16 || n % 2) return cudaErrorInvalidValue;
  tiles::tile_launch_shape(n, 1, bsz, n, n, info);
  return cudaSuccess;
}

extern "C" int karatsuba_ppm_attributes(int bsz, int n, int* info) {
  switch (n) {
    case 2: return tiles::attributes(karatsuba_ppm_kernel<2>, info);
    case 4: return tiles::attributes(karatsuba_ppm_kernel<4>, info);
    case 6: return tiles::attributes(karatsuba_ppm_kernel<6>, info);
    case 8: return tiles::attributes(karatsuba_ppm_kernel<8>, info);
    case 10: return tiles::attributes(karatsuba_ppm_kernel<10>, info);
    case 12: return tiles::attributes(karatsuba_ppm_kernel<12>, info);
    case 14: return tiles::attributes(karatsuba_ppm_kernel<14>, info);
    case 16: return tiles::attributes(karatsuba_ppm_kernel<16>, info);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int karatsuba_ppm_bulk_launch_shape(int bsz, int n, int* info) {
  return bulk_launch_at(bsz, n, info);
}

extern "C" int karatsuba_ppm_bulk_attributes(int bsz, int n, int* info) {
  if (n != 2) return cudaErrorInvalidValue;
  return tiles::attributes(karatsuba_ppm_bulk_kernel, info);
}
