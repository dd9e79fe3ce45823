// Fused bank round: every instance's folded multiplications in ONE launch.
//
// Replaces the TPU kernel `_bank_kernel` / `fused_bank_mul` of the
// reference package (kernels/bank_fold/kernel.py:44, :88). It computes a
// round's (B, LA) x (B, LB) -> (B, LA+LB) limbs with the rows in batch
// order: row k is multiplied by instance owner[k], whose schedule table
// rows table[i, j] = (lo, hi) give its B-limb windows ((0, 0) marks an
// idle step). For each step, B is restricted to the window, the
// window's schoolbook partial products go into a full-width LA+LB
// uint32 carry-save accumulator, and one carry pass after the last step
// retires the product. The reference computes an instance's block of
// gathered rows; reading the batch's own rows with an owner a row takes
// the gathers of the operands into blocks, and of the products back into
// batch order, off the device: those cost a row each, several times the
// round itself.
//
// Design. The TPU grid (row tile, instance, step) runs its step axis in
// order, carrying the accumulator in VMEM scratch between steps. Here a
// thread owns a row, limbs and accumulator in registers (kernels are
// templated on the operand width). The step axis folds into per-limb
// weights: for every B limb, the steps of the row's instance whose
// window holds it; one schoolbook pass then adds each partial product
// that many times (tiles::schoolbook), the same uint32 column sums as the
// reference's loop of masked steps, bit for bit. The weights multiply
// (no limb of weight 0 is skipped), so a warp whose rows belong to
// different instances runs one instruction stream.
//
// Bound. At the registry widths a row moves 4 * 2 * (LA + LB) bytes and
// its 4-byte owner for about 5 * LA * width + 3 * (LA + LB) integer
// operations (width: the window limbs summed over steps), so
// device-memory bytes bound it on the H100: 3.35 TB/s against 16.7
// Tops/s of int32 work. What a thread reading its row straight from
// device memory loses is the store pattern: its LA+LB 4-byte stores fall
// at a stride of LA+LB words across a warp, so at 8 limbs a warp's store
// instruction touches 32 sectors for 128 bytes. The rows move as tiles
// instead (row_tiles.cuh):
// * bank_fold_bulk_kernel (LA = LB = 2, 4, 8, 16 or 24, 16-byte-aligned
//   operands, at most kMaxInstances instances): a persistent grid (from
//   8 limbs two blocks an SM, at 2 and 4 as many as fit); each block
//   first counts every instance's limb weights from the table into
//   shared memory, then walks row tiles of the batch. A ring of stages
//   holds the next tiles' A and B spans, brought in by 1-D TMA bulk
//   copies on mbarriers while the current tile computes; a thread loads
//   the owners of its rows of the next tile beside them and reads each
//   row's weights from the block's copy. Products leave through shared
//   memory in one bulk store a tile; at 2 limbs a product is one 16-byte
//   vector, stored straight from registers. Tiles, stages and blocks an
//   SM are compile-time constants of the width (tiles::Bulk).
// * bank_fold_kernel (everything else: misaligned views, odd row counts
//   at 2 limbs, mixed or odd widths, more instances): one block a tile,
//   rows, owners and the owner's windows loaded straight from device
//   memory, products wider than 16 bytes stored through shared memory
//   with neighbouring threads on neighbouring words.
// The host picks the path (kernels/bank_fold/kernel.py `launch_plan`); a
// launch the bulk path cannot take returns cudaErrorInvalidValue, as does
// one of rows wider than limbs::kMaxLimbs on either path.
//
// Rows of 24 limbs (BLS12-381's 381-bit field elements, 2 * 24 operand
// limbs and 48 product limbs a thread) multiply column by column into
// one 64-bit sum (tiles::schoolbook_by_columns) rather than into 48
// uint32 columns beside 24 weights: fewer registers and a fifth of the
// instructions, and the same bits.
#include "row_tiles.cuh"

namespace {

// Instances a bulk launch takes: a block keeps every instance's L limb
// weights in shared memory after the walk's buffers (kernels/_row_tiles.py
// BULK_INSTANCES). At this many a block still fits as often an SM as
// tiles::Bulk<L> alone does, at every width.
constexpr int kMaxInstances = 128;

template <int L>
constexpr size_t weight_bytes(int n_inst) {
  return (size_t)n_inst * L * 4;
}

// B limb jb of instance `inst` enters a product once for every step of
// the instance whose window holds it: one limb's weight (a bulk block
// stages every instance's this way, a thread a word, with no array of
// weights live beside the walk's registers).
__device__ __forceinline__ uint32_t limb_weight(const int32_t* table,
                                                int max_steps, int inst,
                                                int jb) {
  const int32_t* w = table + (size_t)inst * max_steps * 2;
  uint32_t c = 0u;
  for (int j = 0; j < max_steps; ++j) {
    c += jb >= __ldg(w + 2 * j) && jb < __ldg(w + 2 * j + 1);
  }
  return c;
}

// All M limb weights of instance `inst` (the per-thread path): two loads
// a step, the same for every limb.
template <int M>
__device__ __forceinline__ void table_weights(const int32_t* table,
                                              int max_steps, int inst,
                                              uint32_t (&c)[M]) {
  const int32_t* w = table + (size_t)inst * max_steps * 2;
#pragma unroll
  for (int jb = 0; jb < M; ++jb) c[jb] = 0u;
  // two steps an iteration: on the H100 the kernels then hold fewer
  // registers at every width (24 limbs: 105, against 109 left to nvcc)
#pragma unroll 2
  for (int j = 0; j < max_steps; ++j) {
    const int lo = __ldg(w + 2 * j), hi = __ldg(w + 2 * j + 1);
#pragma unroll
    for (int jb = 0; jb < M; ++jb) c[jb] += jb >= lo && jb < hi;
  }
}

// Rows in batch order, row k of instance owner[k]. kStaged: the weights
// are read from the block's copy in shared memory (`staged`, n_inst x M
// words; the bulk path), else counted from the table by each thread (the
// per-thread path).
template <bool kStaged>
struct BankRows {
  const int32_t* owner;    // (B,) instance of each row
  const int32_t* table;    // (n_inst, max_steps, 2) windows
  const uint32_t* staged;  // kStaged: (n_inst, M) weights
  int max_steps;

  __device__ __forceinline__ int row_owner(size_t row) const {
    return __ldg(owner + row);
  }

  template <int M>
  __device__ __forceinline__ void row_weights(int inst,
                                              uint32_t (&c)[M]) const {
    if constexpr (kStaged) {
      const uint32_t* w = staged + inst * M;
      if constexpr (M % 4 == 0) {
#pragma unroll
        for (int q = 0; q < M / 4; ++q) {
          const uint4 x = reinterpret_cast<const uint4*>(w)[q];
          c[4 * q] = x.x;
          c[4 * q + 1] = x.y;
          c[4 * q + 2] = x.z;
          c[4 * q + 3] = x.w;
        }
      } else {
        const uint2 x = *reinterpret_cast<const uint2*>(w);
        c[0] = x.x;
        c[1] = x.y;
      }
    } else {
      table_weights<M>(table, max_steps, inst, c);
    }
  }

  template <int M>
  __device__ __forceinline__ void product(const uint32_t (&a)[M],
                                          const uint32_t (&b)[M],
                                          const uint32_t (&w)[M],
                                          uint32_t (&cols)[2 * M],
                                          int n) const {
    tiles::schoolbook<M, false>(a, b, w, cols, n);
  }
};

template <int L>
__global__ void __launch_bounds__(tiles::Bulk<L>::kThreads)
    bank_fold_bulk_kernel(const uint32_t* __restrict__ a,
                          const uint32_t* __restrict__ b,
                          const int32_t* __restrict__ owner,
                          const int32_t* __restrict__ table,
                          uint32_t* __restrict__ out, int n_inst, int rows,
                          int max_steps) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint32_t* staged =
      reinterpret_cast<uint32_t*>(smem + tiles::Bulk<L>::kBytes);
  for (int e = threadIdx.x; e < n_inst * L; e += blockDim.x) {
    staged[e] = limb_weight(table, max_steps, e / L, e % L);
  }
  __syncthreads();
  tiles::bulk_walk<L>(a, b, out, rows, smem,
                      BankRows<true>{owner, table, staged, max_steps});
}

template <int MAXL>
__global__ void __launch_bounds__(tiles::kTileRows)
    bank_fold_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     const int32_t* __restrict__ owner,
                     const int32_t* __restrict__ table,
                     uint32_t* __restrict__ out, int rows, int la, int lb,
                     int max_steps) {
  extern __shared__ __align__(128) uint8_t smem[];
  tiles::coalesced_tile<MAXL>(a, b, out, blockIdx.x, rows, la, lb,
                              reinterpret_cast<uint32_t*>(smem),
                              BankRows<false>{owner, table, nullptr,
                                              max_steps});
}

// The bulk launch at L limbs over a round of n_inst instances
// (tiles::bulk_launch_shape, the instances' weights after the walk's
// buffers).
template <int L>
cudaError_t bulk_launch_at(int n_inst, int rows, int* info) {
  if (n_inst < 1 || n_inst > kMaxInstances) return cudaErrorInvalidValue;
  return tiles::bulk_launch_shape<L>(bank_fold_bulk_kernel<L>, rows, info,
                                     weight_bytes<L>(n_inst),
                                     weight_bytes<L>(kMaxInstances));
}

template <int L>
cudaError_t launch_bulk(const uint32_t* a, const uint32_t* b,
                        const int32_t* owner, const int32_t* table,
                        uint32_t* out, int n_inst, int rows, int max_steps,
                        cudaStream_t stream) {
  if (!tiles::aligned16(a) || !tiles::aligned16(b) ||
      !tiles::aligned16(out)) {
    return cudaErrorInvalidValue;
  }
  int info[4];
  const cudaError_t err = bulk_launch_at<L>(n_inst, rows, info);
  if (err != cudaSuccess) return err;
  bank_fold_bulk_kernel<L><<<info[0], info[2], info[3], stream>>>(
      a, b, owner, table, out, n_inst, rows, max_steps);
  return cudaGetLastError();
}

template <int MAXL>
cudaError_t launch(const uint32_t* a, const uint32_t* b,
                   const int32_t* owner, const int32_t* table,
                   uint32_t* out, int rows, int la, int lb, int max_steps,
                   cudaStream_t stream) {
  int info[4];
  tiles::tile_launch_shape(MAXL, rows, la, lb, info);
  bank_fold_kernel<MAXL><<<info[0], info[2], info[3], stream>>>(
      a, b, owner, table, out, rows, la, lb, max_steps);
  return cudaGetLastError();
}

}  // namespace

// The coalesced path, any widths up to limbs::kMaxLimbs, any alignment
// and any number of instances.
extern "C" int bank_fold_launch(const void* a, const void* b,
                                const void* owner, const void* table,
                                void* out, int n_inst, int rows, int la,
                                int lb, int max_steps, void* stream) {
  return limbs::with_bucket(la, lb, [&](auto w) {
    return launch<decltype(w)::value>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<const int32_t*>(owner),
        static_cast<const int32_t*>(table), static_cast<uint32_t*>(out),
        rows, la, lb, max_steps, static_cast<cudaStream_t>(stream));
  });
}

// The bulk path: LA = LB = 2, 4, 8, 16 or 24 limbs, 16-byte-aligned
// operands, rows * LA a multiple of 4, 1 to kMaxInstances instances.
extern "C" int bank_fold_bulk_launch(const void* a, const void* b,
                                     const void* owner, const void* table,
                                     void* out, int n_inst, int rows,
                                     int la, int lb, int max_steps,
                                     void* stream) {
  return tiles::with_bulk_width(la, lb, [&](auto w) {
    return launch_bulk<decltype(w)::value>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<const int32_t*>(owner),
        static_cast<const int32_t*>(table), static_cast<uint32_t*>(out),
        n_inst, rows, max_steps, static_cast<cudaStream_t>(stream));
  });
}

// The launch each entry above makes for these arguments, and the
// attributes of the kernel it launches: info = {grid.x, grid.y, threads,
// dynamic shared bytes} and {registers, local bytes, static shared
// bytes, most threads a block} (the launch contracts of
// kernels/bank_fold/ops.py are held to them).
extern "C" int bank_fold_launch_shape(int n_inst, int rows, int la, int lb,
                                      int max_steps, int* info) {
  const int maxl = limbs::bucket(la, lb);
  if (maxl == 0) return cudaErrorInvalidValue;
  tiles::tile_launch_shape(maxl, rows, la, lb, info);
  return cudaSuccess;
}

extern "C" int bank_fold_attributes(int n_inst, int rows, int la, int lb,
                                    int max_steps, int* info) {
  return limbs::with_bucket(la, lb, [&](auto w) {
    return tiles::attributes(bank_fold_kernel<decltype(w)::value>, info);
  });
}

extern "C" int bank_fold_bulk_launch_shape(int n_inst, int rows, int la,
                                           int lb, int max_steps,
                                           int* info) {
  return tiles::with_bulk_width(la, lb, [&](auto w) {
    return bulk_launch_at<decltype(w)::value>(n_inst, rows, info);
  });
}

extern "C" int bank_fold_bulk_attributes(int n_inst, int rows, int la,
                                         int lb, int max_steps, int* info) {
  return tiles::with_bulk_width(la, lb, [&](auto w) {
    return tiles::attributes(bank_fold_bulk_kernel<decltype(w)::value>,
                             info);
  });
}
