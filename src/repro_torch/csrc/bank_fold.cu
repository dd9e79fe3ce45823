// Fused bank round: every instance's folded multiplications in ONE launch.
//
// Replaces the TPU kernel `_bank_kernel` / `fused_bank_mul` of the
// reference package (kernels/bank_fold/kernel.py:44, :88). It computes
// (N_INST, R, LA) x (N_INST, R, LB) -> (N_INST, R, LA+LB) limbs: for
// instance i and step j, B is restricted to the window
// table[i, j] = (lo, hi) ((0, 0) marks an idle step), the window's
// schoolbook partial products go into a full-width LA+LB uint32
// carry-save accumulator, and one carry pass after the last step
// retires the product.
//
// Design. The TPU grid (row tile, instance, step) runs its step axis in
// order, carrying the accumulator in VMEM scratch between steps. Here a
// thread owns a row, limbs and accumulator in registers (kernels are
// templated on the operand width). The step axis folds into per-limb
// weights: once a tile, each thread counts, for every B limb, the steps
// whose window holds it (on the bulk path a warp reads its instance's
// windows with one load, a window word a lane, and shares them by
// shuffles); one schoolbook pass then adds each partial product that
// many times (tiles::schoolbook), the same uint32 column sums as the
// reference's loop of masked steps, bit for bit.
//
// Bound. At the registry widths a row moves 4 * 2 * (LA + LB) bytes for
// about 5 * LA * width + 3 * (LA + LB) integer operations (width: the
// window limbs summed over steps), so device-memory bytes bound it on
// the H100: 3.35 TB/s against 16.7 Tops/s of int32 work. What a thread
// reading its row straight from device memory loses is the store
// pattern: its LA+LB 4-byte stores fall at a stride of LA+LB words
// across a warp, so at 8 limbs a warp's store instruction touches 32
// sectors for 128 bytes. The rows move as tiles instead (row_tiles.cuh):
// * bank_fold_bulk_kernel (LA = LB = 2, 4, 8, 16 or 24, 16-byte-aligned
//   spans): a persistent grid (from 8 limbs two blocks an SM, at 2 and 4
//   as many as fit); each block walks (instance, row tile) pairs,
//   a tile never crossing instances, so the weights are warp-uniform. A
//   ring of stages holds the next tiles' A and B spans, brought in by
//   1-D TMA bulk copies on mbarriers while the current tile computes.
//   Products leave through shared memory in one bulk store a tile; at 2
//   limbs a product is one 16-byte vector, stored straight from
//   registers. Tiles, stages and blocks an SM are compile-time constants
//   of the width (tiles::Bulk).
// * bank_fold_kernel (everything else: misaligned views, odd row counts
//   at 2 limbs, mixed or odd widths): one block a tile, rows loaded
//   straight from device memory, products wider than 16 bytes stored
//   through shared memory with neighbouring threads on neighbouring
//   words.
// The host picks the path (kernels/_row_tiles.py `plan`); a launch the
// bulk path cannot take returns cudaErrorInvalidValue, as does one of
// rows wider than limbs::kMaxLimbs on either path.
//
// Rows of 24 limbs (BLS12-381's 381-bit field elements, 2 * 24 operand
// limbs and 48 product limbs a thread) multiply column by column into
// one 64-bit sum (tiles::schoolbook_by_columns) rather than into 48
// uint32 columns beside 24 weights: fewer registers and a fifth of the
// instructions, and the same bits.
#include "row_tiles.cuh"

namespace {

// The schedule table as limb weights: B limb jb of instance `inst`
// enters the product once for every step whose window holds it.
struct BankFold {
  const int32_t* table;  // (n_inst, max_steps, 2) windows
  int max_steps;

  // Each thread reads the windows itself: the same address across the
  // warp, one broadcast load a word (the per-thread path, where a tile
  // is one row a thread).
  template <int M>
  __device__ __forceinline__ void weights(int inst, uint32_t (&c)[M]) const {
    const int32_t* w = table + (size_t)inst * max_steps * 2;
#pragma unroll
    for (int jb = 0; jb < M; ++jb) c[jb] = 0u;
    for (int j = 0; j < max_steps; ++j) {
      const int lo = __ldg(w + 2 * j), hi = __ldg(w + 2 * j + 1);
#pragma unroll
      for (int jb = 0; jb < M; ++jb) c[jb] += jb >= lo && jb < hi;
    }
  }

  // The same weights, the warp reading the windows once: lane k loads
  // word k (32 words at a time) and the warp shares them by shuffles
  // (the bulk walk, once a tile). Every lane of the warp calls it.
  template <int M>
  __device__ __forceinline__ void warp_weights(int inst,
                                               uint32_t (&c)[M]) const {
    const int32_t* w = table + (size_t)inst * max_steps * 2;
    const int words = 2 * max_steps, lane = threadIdx.x % 32;
#pragma unroll
    for (int jb = 0; jb < M; ++jb) c[jb] = 0u;
    for (int base = 0; base < words; base += 32) {
      const int32_t mine = base + lane < words ? __ldg(w + base + lane) : 0;
      const int n = min(32, words - base);
      for (int k = 0; k < n; k += 2) {
        const int lo = __shfl_sync(0xFFFFFFFFu, mine, k);
        const int hi = __shfl_sync(0xFFFFFFFFu, mine, k + 1);
#pragma unroll
        for (int jb = 0; jb < M; ++jb) c[jb] += jb >= lo && jb < hi;
      }
    }
  }

  template <int M>
  __device__ __forceinline__ void product(const uint32_t (&a)[M],
                                          const uint32_t (&b)[M],
                                          const uint32_t (&w)[M],
                                          uint32_t (&cols)[2 * M],
                                          int n) const {
    tiles::schoolbook<M>(a, b, w, cols, n);
  }
};

template <int L>
__global__ void __launch_bounds__(tiles::Bulk<L>::kThreads)
    bank_fold_bulk_kernel(const uint32_t* __restrict__ a,
                          const uint32_t* __restrict__ b,
                          const int32_t* __restrict__ table,
                          uint32_t* __restrict__ out, int n_inst, int rows,
                          int max_steps) {
  extern __shared__ __align__(128) uint8_t smem[];
  tiles::bulk_walk<L>(a, b, out, n_inst, rows, smem,
                      BankFold{table, max_steps});
}

template <int MAXL>
__global__ void __launch_bounds__(tiles::kTileRows)
    bank_fold_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     const int32_t* __restrict__ table,
                     uint32_t* __restrict__ out, int rows, int la, int lb,
                     int max_steps) {
  extern __shared__ __align__(128) uint8_t smem[];
  tiles::coalesced_tile<MAXL>(a, b, out, blockIdx.y, blockIdx.x, rows, la,
                              lb, reinterpret_cast<uint32_t*>(smem),
                              BankFold{table, max_steps});
}

// The bulk launch at L limbs (tiles::bulk_launch_shape).
template <int L>
cudaError_t bulk_launch_at(int n_inst, int rows, int* info) {
  return tiles::bulk_launch_shape<L>(bank_fold_bulk_kernel<L>, n_inst, rows,
                                     info);
}

template <int L>
cudaError_t launch_bulk(const uint32_t* a, const uint32_t* b,
                        const int32_t* table, uint32_t* out, int n_inst,
                        int rows, int max_steps, cudaStream_t stream) {
  if (!tiles::aligned16(a) || !tiles::aligned16(b) ||
      !tiles::aligned16(out)) {
    return cudaErrorInvalidValue;
  }
  int info[4];
  const cudaError_t err = bulk_launch_at<L>(n_inst, rows, info);
  if (err != cudaSuccess) return err;
  bank_fold_bulk_kernel<L><<<info[0], info[2], info[3], stream>>>(
      a, b, table, out, n_inst, rows, max_steps);
  return cudaGetLastError();
}

template <int MAXL>
cudaError_t launch(const uint32_t* a, const uint32_t* b,
                   const int32_t* table, uint32_t* out, int n_inst,
                   int rows, int la, int lb, int max_steps,
                   cudaStream_t stream) {
  int info[4];
  tiles::tile_launch_shape(MAXL, n_inst, rows, la, lb, info);
  bank_fold_kernel<MAXL><<<dim3(info[0], info[1]), info[2], info[3],
                           stream>>>(a, b, table, out, rows, la, lb,
                                     max_steps);
  return cudaGetLastError();
}

}  // namespace

// The coalesced path, any widths up to limbs::kMaxLimbs and any
// alignment.
extern "C" int bank_fold_launch(const void* a, const void* b,
                                const void* table, void* out, int n_inst,
                                int rows, int la, int lb, int max_steps,
                                void* stream) {
  auto* pa = static_cast<const uint32_t*>(a);
  auto* pb = static_cast<const uint32_t*>(b);
  auto* pt = static_cast<const int32_t*>(table);
  auto* po = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (limbs::too_wide(la, lb)) return cudaErrorInvalidValue;
  switch (limbs::bucket(la, lb)) {
    case 2: return launch<2>(pa, pb, pt, po, n_inst, rows, la, lb, max_steps, s);
    case 4: return launch<4>(pa, pb, pt, po, n_inst, rows, la, lb, max_steps, s);
    case 8: return launch<8>(pa, pb, pt, po, n_inst, rows, la, lb, max_steps, s);
    case 16: return launch<16>(pa, pb, pt, po, n_inst, rows, la, lb, max_steps, s);
    default: return launch<24>(pa, pb, pt, po, n_inst, rows, la, lb, max_steps, s);
  }
}

// The bulk path: LA = LB = 2, 4, 8, 16 or 24 limbs, 16-byte-aligned
// operands, rows * LA a multiple of 4.
extern "C" int bank_fold_bulk_launch(const void* a, const void* b,
                                     const void* table, void* out,
                                     int n_inst, int rows, int la, int lb,
                                     int max_steps, void* stream) {
  auto* pa = static_cast<const uint32_t*>(a);
  auto* pb = static_cast<const uint32_t*>(b);
  auto* pt = static_cast<const int32_t*>(table);
  auto* po = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (la != lb) return cudaErrorInvalidValue;
  switch (la) {
    case 2: return launch_bulk<2>(pa, pb, pt, po, n_inst, rows, max_steps, s);
    case 4: return launch_bulk<4>(pa, pb, pt, po, n_inst, rows, max_steps, s);
    case 8: return launch_bulk<8>(pa, pb, pt, po, n_inst, rows, max_steps, s);
    case 16: return launch_bulk<16>(pa, pb, pt, po, n_inst, rows, max_steps, s);
    case 24: return launch_bulk<24>(pa, pb, pt, po, n_inst, rows, max_steps, s);
    default: return cudaErrorInvalidValue;
  }
}

// The bulk kernel's shape at la limbs on this device (tiles::bulk_shape).
extern "C" int bank_fold_bulk_shape(int la, int* info) {
  switch (la) {
    case 2: return tiles::bulk_shape<2>(bank_fold_bulk_kernel<2>, info);
    case 4: return tiles::bulk_shape<4>(bank_fold_bulk_kernel<4>, info);
    case 8: return tiles::bulk_shape<8>(bank_fold_bulk_kernel<8>, info);
    case 16: return tiles::bulk_shape<16>(bank_fold_bulk_kernel<16>, info);
    case 24: return tiles::bulk_shape<24>(bank_fold_bulk_kernel<24>, info);
    default: return cudaErrorInvalidValue;
  }
}

// The launch each entry above makes for these arguments, and the
// attributes of the kernel it launches: info = {grid.x, grid.y, threads,
// dynamic shared bytes} and {registers, local bytes, static shared
// bytes, most threads a block} (the launch contracts of
// kernels/bank_fold/ops.py are held to them).
extern "C" int bank_fold_launch_shape(int n_inst, int rows, int la, int lb,
                                      int max_steps, int* info) {
  if (limbs::too_wide(la, lb)) return cudaErrorInvalidValue;
  tiles::tile_launch_shape(limbs::bucket(la, lb), n_inst, rows, la, lb,
                           info);
  return cudaSuccess;
}

extern "C" int bank_fold_attributes(int n_inst, int rows, int la, int lb,
                                    int max_steps, int* info) {
  switch (limbs::bucket(la, lb)) {
    case 2: return tiles::attributes(bank_fold_kernel<2>, info);
    case 4: return tiles::attributes(bank_fold_kernel<4>, info);
    case 8: return tiles::attributes(bank_fold_kernel<8>, info);
    case 16: return tiles::attributes(bank_fold_kernel<16>, info);
    default: return tiles::attributes(bank_fold_kernel<24>, info);
  }
}

extern "C" int bank_fold_bulk_launch_shape(int n_inst, int rows, int la,
                                           int lb, int max_steps,
                                           int* info) {
  if (la != lb) return cudaErrorInvalidValue;
  switch (la) {
    case 2: return bulk_launch_at<2>(n_inst, rows, info);
    case 4: return bulk_launch_at<4>(n_inst, rows, info);
    case 8: return bulk_launch_at<8>(n_inst, rows, info);
    case 16: return bulk_launch_at<16>(n_inst, rows, info);
    case 24: return bulk_launch_at<24>(n_inst, rows, info);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int bank_fold_bulk_attributes(int n_inst, int rows, int la,
                                         int lb, int max_steps, int* info) {
  if (la != lb) return cudaErrorInvalidValue;
  switch (la) {
    case 2: return tiles::attributes(bank_fold_bulk_kernel<2>, info);
    case 4: return tiles::attributes(bank_fold_bulk_kernel<4>, info);
    case 8: return tiles::attributes(bank_fold_bulk_kernel<8>, info);
    case 16: return tiles::attributes(bank_fold_bulk_kernel<16>, info);
    case 24: return tiles::attributes(bank_fold_bulk_kernel<24>, info);
    default: return cudaErrorInvalidValue;
  }
}
