// Per-instance folded multipliers: the "kernel" capability of a bank.
//
// Replaces the three kernel bodies of the reference package's
// kernels/mcim_fold/kernel.py, each (B, LA) x (B, LB) -> (B, LA+LB):
//   _fb_kernel   (:93)  Feedback fold (Star at CT=1),
//   _ff_kernel   (:146) Feed-forward fold,
//   _kara_kernel (:203) folded Karatsuba at CT=3 (_kara_fold_call :277).
//
// Design. On the TPU the grid is (row tile, cycle) and the cycle axis
// runs in order, the VMEM scratch playing the feedback register (FB),
// the register file (FF) or the compressor feedback (Karatsuba). Here a
// thread owns one multiplication (row) and the cycle axis folds away
// inside it: every kernel computes the row's exact product, limbs in
// registers, templated on the operand width so every limb array is
// indexed statically, and the rows move as tiles (row_tiles.cuh).
//
// The folded Karatsuba is exact too. Its three cycles run one shared PPM
// on (A0, B0), (A1, B1) and (A0+A1, B0+B1) and accumulate
// P = T0 + T1<<2H + (T2 - T1 - T0)<<H on 2N columns, the operands padded
// with zero limbs to N = max(LA, LB) rounded up to even, and its final
// adder keeps LA+LB limbs: the product mod 2**(16 (LA+LB)), which is the
// product itself, as an LA-limb times an LB-limb operand is below that.
// kara_fold_kernel computes the same value with the spatial Karatsuba's
// row arithmetic (kara_rows.cuh, KaraRows<N>): the per-thread tile loads
// LA and LB limbs zero-filled to N, KaraRows::product forms the 2N
// columns of the padded rows' product (A*B mod 2**(32N), with the
// complements) and carries them over [0, LA+LB), and the tile stores
// LA+LB limbs a row. Both are the exact product, so the bits are the
// reference's.
//
// Bound: at the registry widths (1 to 8 limbs) memory bytes bound all
// three on the H100: a row moves 4 (LA + LB) bytes in and 4 (LA + LB)
// out against a few hundred integer operations. Rows of up to
// limbs::kMaxLimbs = 24 limbs (BLS12-381's 381-bit field elements) are
// taken; above 16, FB and FF multiply column by column
// (tiles::schoolbook_by_columns) and the folded Karatsuba's half-width
// products are of 9 to 13 limbs (N = 18 to 24).
#include "kara_rows.cuh"

namespace {

// FB and FF, the ports of _fb_kernel and _ff_kernel
// (kernels/mcim_fold/kernel.py:93, :146), compute the same function, the
// exact product, so one pair of kernels runs both (their launches count
// apart, on the host).
// * FF sums CT partial-product windows into one register file and
//   carries once: the windows [j*chunk, (j+1)*chunk) take every B limb
//   below ct_run * chunk once.
// * FB adds cycle j's window to the previous result shifted down by one
//   chunk and runs its 1CA over the M + N/CT (+carry) window every cycle,
//   retiring the low chunk. For every geometry fold_geometry allows
//   (ct_run * chunk >= LB) each cycle's window sum stays below
//   2**(16 (LA + chunk + 1)), so no 1CA drops a carry, and the limbs FB
//   retires are the exact product. One schoolbook pass with every B limb
//   below ct_run * chunk at weight 1, then one carry pass truncated to
//   LA+LB, gives the same bits: the uint32 column sums stay below
//   2 * 16 * (2**16 - 1) < 2**32, and both results are the product mod
//   2**(16 (LA+LB)), which is the product itself.
// As ct_run * chunk >= LB, and the limbs above LB are zero (the loads
// zero-fill them; on the bulk path LA = LB), every B limb has weight 1:
// neither the cycles nor the chunk reach the kernels, and both multiply
// by tiles::schoolbook with all-ones weights, bit for bit with the
// reference. What bounds them on the H100 is moving rows, not the
// arithmetic (at 2 limbs a row reads 16 B and writes 16 B for about 32
// integer operations: per million rows, 9.6 us of bytes at 3.35 TB/s
// against 1.9 us of operations at 16.7 Tops/s), and a thread storing its
// LA+LB limbs at a stride of LA+LB words touches many sectors a warp
// instruction. So the rows move as tiles (row_tiles.cuh):
// * fold_bulk_kernel (LA = LB = 2, 4, 8, 16 or 24, 16-byte-aligned
//   spans):
//   a persistent grid walks the row tiles; a ring of stages
//   keeps the next tiles' A and B spans in flight as 1-D TMA bulk copies
//   on mbarriers while the current tile computes, rows are read from
//   shared memory as 8- or 16-byte vectors, and each tile's products
//   leave in one bulk store (at 2 limbs each thread stores its 16-byte
//   product itself). Tiles, stages and blocks an SM are compile-time
//   constants of the width (tiles::Bulk);
// * fold_kernel (everything else: misaligned views, odd row counts at 2
//   limbs, mixed or odd widths): one block a tile, rows loaded straight
//   from device memory, products wider than 16 bytes stored through
//   shared memory with neighbouring threads on neighbouring words.
// The host picks the path (kernels/_row_tiles.py `plan`); a launch the
// bulk path cannot take returns cudaErrorInvalidValue, as does one of
// rows wider than limbs::kMaxLimbs on any path.
struct ExactRows {
  __device__ __forceinline__ int row_owner(size_t) const { return 0; }
  template <int M>
  __device__ __forceinline__ void row_weights(int, uint32_t (&c)[M]) const {
#pragma unroll
    for (int jb = 0; jb < M; ++jb) c[jb] = 1u;
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
    fold_bulk_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     uint32_t* __restrict__ out, int bsz) {
  extern __shared__ __align__(128) uint8_t smem[];
  tiles::bulk_walk<L>(a, b, out, bsz, smem, ExactRows{});
}

template <int MAXL>
__global__ void __launch_bounds__(tiles::kTileRows)
    fold_kernel(const uint32_t* __restrict__ a,
                const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                int bsz, int la, int lb) {
  extern __shared__ __align__(128) uint8_t smem[];
  tiles::coalesced_tile<MAXL>(a, b, out, blockIdx.x, bsz, la, lb,
                              reinterpret_cast<uint32_t*>(smem),
                              ExactRows{});
}

// The folded Karatsuba on the per-thread path: rows of LA and LB limbs
// as rows of N, N = max(LA, LB) rounded up to even.
template <int N>
__global__ void __launch_bounds__(tiles::kTileRows)
    kara_fold_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     uint32_t* __restrict__ out, int bsz, int la, int lb) {
  extern __shared__ __align__(128) uint8_t smem[];
  tiles::coalesced_tile<N>(a, b, out, blockIdx.x, bsz, la, lb,
                           reinterpret_cast<uint32_t*>(smem),
                           kara::KaraRows<N>{});
}

// A per-thread kernel of MAXL limbs (fold_kernel, kara_fold_kernel): one
// block a tile (tiles::tile_launch_shape).
template <int MAXL, class Kernel>
cudaError_t launch_tiles(Kernel kernel, const void* a, const void* b,
                         void* out, int bsz, int la, int lb, void* stream) {
  int info[4];
  tiles::tile_launch_shape(MAXL, bsz, la, lb, info);
  kernel<<<info[0], info[2], info[3], static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), bsz, la, lb);
  return cudaGetLastError();
}

// FB's and FF's bulk launch at L limbs (tiles::bulk_launch_shape).
template <int L>
cudaError_t bulk_launch_at(int bsz, int* info) {
  return tiles::bulk_launch_shape<L>(fold_bulk_kernel<L>, bsz, info);
}

template <int L>
cudaError_t launch_fold_bulk(const void* a, const void* b, void* out,
                             int bsz, void* stream) {
  if (!tiles::aligned16(a) || !tiles::aligned16(b) ||
      !tiles::aligned16(out)) {
    return cudaErrorInvalidValue;
  }
  int info[4];
  const cudaError_t err = bulk_launch_at<L>(bsz, info);
  if (err != cudaSuccess) return err;
  fold_bulk_kernel<L><<<info[0], info[2], info[3],
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), bsz);
  return cudaGetLastError();
}

// N of the folded Karatsuba's rows: max(LA, LB) rounded up to even.
inline int kara_n(int la, int lb) {
  const int n = la > lb ? la : lb;
  return n + n % 2;
}

}  // namespace

// FB and FF (one function, the exact product) on the per-thread path:
// a, b: (bsz, la), (bsz, lb) limbs; out: (bsz, la + lb); any widths up
// to limbs::kMaxLimbs, any 4-byte alignment.
extern "C" int mcim_fold_launch(const void* a, const void* b, void* out,
                                int bsz, int la, int lb, void* stream) {
  return limbs::with_bucket(la, lb, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return launch_tiles<W>(fold_kernel<W>, a, b, out, bsz, la, lb, stream);
  });
}

// FB and FF on the bulk path: LA = LB = 2, 4, 8, 16 or 24 limbs,
// 16-byte-aligned operands, bsz * LA a multiple of 4.
extern "C" int mcim_fold_bulk_launch(const void* a, const void* b,
                                     void* out, int bsz, int la, int lb,
                                     void* stream) {
  return tiles::with_bulk_width(la, lb, [&](auto w) {
    return launch_fold_bulk<decltype(w)::value>(a, b, out, bsz, stream);
  });
}

// The folded Karatsuba: a, b: (bsz, la), (bsz, lb) limbs; out: (bsz,
// la + lb); any widths up to limbs::kMaxLimbs, any 4-byte alignment.
extern "C" int mcim_fold_karatsuba_launch(const void* a, const void* b,
                                          void* out, int bsz, int la,
                                          int lb, void* stream) {
  return kara::EvenN::dispatch(kara_n(la, lb), [&](auto w) {
    constexpr int N = decltype(w)::value;
    return launch_tiles<N>(kara_fold_kernel<N>, a, b, out, bsz, la, lb,
                           stream);
  });
}

// The launch each entry above makes for these arguments, and the
// attributes of the kernel it launches: info = {grid.x, grid.y, threads,
// dynamic shared bytes} and {registers, local bytes, static shared
// bytes, most threads a block} (the launch contracts of
// kernels/mcim_fold/ops.py are held to them).
extern "C" int mcim_fold_launch_shape(int bsz, int la, int lb, int* info) {
  const int maxl = limbs::bucket(la, lb);
  if (maxl == 0) return cudaErrorInvalidValue;
  tiles::tile_launch_shape(maxl, bsz, la, lb, info);
  return cudaSuccess;
}

extern "C" int mcim_fold_attributes(int bsz, int la, int lb, int* info) {
  return limbs::with_bucket(la, lb, [&](auto w) {
    return tiles::attributes(fold_kernel<decltype(w)::value>, info);
  });
}

extern "C" int mcim_fold_bulk_launch_shape(int bsz, int la, int lb,
                                           int* info) {
  return tiles::with_bulk_width(la, lb, [&](auto w) {
    return bulk_launch_at<decltype(w)::value>(bsz, info);
  });
}

extern "C" int mcim_fold_bulk_attributes(int bsz, int la, int lb,
                                         int* info) {
  return tiles::with_bulk_width(la, lb, [&](auto w) {
    return tiles::attributes(fold_bulk_kernel<decltype(w)::value>, info);
  });
}

extern "C" int mcim_fold_karatsuba_launch_shape(int bsz, int la, int lb,
                                                int* info) {
  const int n = kara_n(la, lb);
  if (!kara::EvenN::contains(n)) return cudaErrorInvalidValue;
  tiles::tile_launch_shape(n, bsz, la, lb, info);
  return cudaSuccess;
}

extern "C" int mcim_fold_karatsuba_attributes(int bsz, int la, int lb,
                                              int* info) {
  return kara::EvenN::dispatch(kara_n(la, lb), [&](auto w) {
    return tiles::attributes(kara_fold_kernel<decltype(w)::value>, info);
  });
}
