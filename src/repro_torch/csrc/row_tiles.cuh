// Row tiles through shared memory: the load and store paths of the limb
// kernels that multiply independent rows, (rows, LA) x (rows, LB) ->
// (rows, LA+LB) limbs, one thread a row, limbs in registers: bank_fold
// (bank_fold.cu), FB and FF (mcim_fold.cu) and the spatial Karatsuba
// (karatsuba_ppm.cu) on both paths below, and the folded Karatsuba
// (mcim_fold.cu) on the per-thread one. What bounds
// them on the H100 is moving those rows, so this header moves the rows
// and leaves a row's arithmetic to the kernel's functor, which supplies
// * `weights(inst, w)`: the state of a tile of instance `inst`, M words,
//   and, for the bulk walk, `warp_weights(inst, w)`: the same, every
//   lane of the warp calling it, once a tile;
// * `product(a, b, w, cols, n)`: the row's product, (M, M) limbs -> 2M
//   columns, carried to canonical limbs over columns [0, n).
// bank_fold, FB and FF multiply by one weighted schoolbook (`schoolbook`
// below): their state is how many of a tile's steps take each B limb
// (FB and FF: 1 for every limb; bank_fold: the windows of the
// instance's schedule table that hold it). Weighting a limb once a tile
// costs fewer instructions than looping over the steps for every row,
// and the bits are the same (see ppm_weighted). Both Karatsuba kernels
// share one functor (kara_rows.cuh, KaraRows), which keeps no state and
// computes its three half-width products.
//
// Two paths, chosen on the host (kernels/_row_tiles.py `plan`):
//
// * bulk_walk, for rows of LA = LB = L limbs (L = 2, 4, 8, 16) whose
//   spans are 16-byte aligned: a persistent grid, each block walking
//   tiles blockIdx.x, blockIdx.x + gridDim.x, ... of Bulk<L>::kTileRows
//   rows inside one instance. One thread issues two 1-D TMA bulk copies a
//   tile (the A span and the B span) into a ring of Bulk<L>::kStages
//   shared buffers, completing on the stage's mbarrier, that many tiles
//   ahead of the compute. Each thread reads its row as 8- or 16-byte
//   vectors (starting lanes on different 16-byte chunks so that a quarter
//   warp hits distinct banks), computes and carries. Above 2 limbs it
//   writes its 2L limbs to one of two output slots, and after a proxy
//   fence one bulk store writes the tile out. At 2 limbs a row's product
//   is one 16-byte vector, so each thread stores it straight from
//   registers: a warp's store is 512 contiguous bytes, and staging it
//   through shared memory only cost time on the H100. Every global
//   access moves whole 16-byte-aligned spans.
// * coalesced_tile, for everything else (misaligned views, odd row
//   counts at L = 2, mixed or odd widths): one block a tile, a thread
//   loading its row straight from device memory; products wider than
//   16 bytes leave through shared memory, with neighbouring threads on
//   neighbouring words.
#pragma once

#include "limbs.cuh"

namespace tiles {

// shared memory a block may use on the H100
constexpr size_t kSmemLimit = 232448;
// rows of a coalesced tile (one thread a row)
constexpr int kTileRows = limbs::kThreads;

// The bulk walk's shape for rows of L limbs, as timed on the H100 (PERF.md
// section 6). At 2 limbs each thread takes two rows a tile: a row is so
// little work that a tile's fixed cost (its barrier wait, __syncthreads
// and index arithmetic) would otherwise dominate, and the products leave
// straight from registers (no output slots). Above, two output slots let
// a tile's bulk store drain while the next tile computes. At 8 and 16
// limbs two blocks an SM; at 2 and 4 as many as fit.
template <int L>
struct Bulk {
  static_assert(L == 2 || L == 4 || L == 8 || L == 16, "bulk widths");
  static constexpr int kRowsPerThread = L == 2 ? 2 : 1;
  static constexpr int kThreads = L <= 4 ? 256 : 128;
  static constexpr int kTileRows = kRowsPerThread * kThreads;
  static constexpr int kStages = L == 4 ? 4 : 2;
  static constexpr int kSlots = L == 2 ? 0 : 2;
  static constexpr int kPerSm = L >= 8 ? 2 : 0;  // 0: as many as fit
  // the ring of A+B tiles (2L words a row), the output slots (2L words
  // a row) and one mbarrier a stage
  static constexpr size_t kBytes =
      (size_t)(kStages + kSlots) * kTileRows * 2 * L * 4 + 8 * kStages;
  static_assert(kBytes <= kSmemLimit, "a bulk block fits shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// 1-D bulk copy of `bytes` global bytes into shared memory, completing
// on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// 1-D bulk copy of `bytes` shared bytes to global memory, in the bulk
// group committed next.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Wait until every bulk group has completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Make this thread's shared-memory writes visible to the bulk copies.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// c[j] <- c[(j - rot) mod C], by selects (rot differs between lanes).
template <int C>
__device__ __forceinline__ void rotate(uint4 (&c)[C], int rot) {
#pragma unroll
  for (int s = 1; s < C; s <<= 1) {
    uint4 t[C];
    const bool take = rot & s;
#pragma unroll
    for (int j = 0; j < C; ++j) t[j] = c[(j - s + C) % C];
#pragma unroll
    for (int j = 0; j < C; ++j) c[j] = take ? t[j] : c[j];
  }
}

// The first 16-byte chunk lane `r` touches in a row of C chunks: rows
// share a 128-byte line 8/C at a time, and the next ones start one
// chunk further, so the 8 lanes of a quarter warp cover 8 distinct
// 16-byte bank groups.
template <int C>
__device__ __forceinline__ int first_chunk(int r) {
  constexpr int kRowsPerLine = C >= 8 ? 1 : 8 / C;
  return (r / kRowsPerLine) % C;
}

// Row r of a tile of W-word rows in shared memory, into registers.
template <int W>
__device__ __forceinline__ void read_row(const uint32_t* tile, int r,
                                         uint32_t (&v)[W]) {
  const uint32_t* row = tile + r * W;
  if constexpr (W == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(row);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    static_assert(W % 4 == 0, "rows of 2 or 4k words");
    constexpr int C = W / 4;
    const int rot = first_chunk<C>(r);
    uint4 c[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {  // c[k] = chunk (k + rot) mod C
      c[k] = reinterpret_cast<const uint4*>(row)[(k + rot) % C];
    }
    rotate<C>(c, rot);             // c[j] = chunk j
#pragma unroll
    for (int j = 0; j < C; ++j) {
      v[4 * j] = c[j].x;
      v[4 * j + 1] = c[j].y;
      v[4 * j + 2] = c[j].z;
      v[4 * j + 3] = c[j].w;
    }
  }
}

// Registers into row r of a tile of W-word rows (W a multiple of 4).
template <int W>
__device__ __forceinline__ void write_row(uint32_t* tile, int r,
                                          const uint32_t (&v)[W]) {
  static_assert(W % 4 == 0, "output rows of 4k words");
  constexpr int C = W / 4;
  const int rot = first_chunk<C>(r);
  uint4 c[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    c[j] = make_uint4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
  rotate<C>(c, (C - rot) % C);     // c[k] = chunk (k + rot) mod C
#pragma unroll
  for (int k = 0; k < C; ++k) {
    reinterpret_cast<uint4*>(tile + r * W)[(k + rot) % C] = c[k];
  }
}

// Schoolbook partial products of a x b, B limb jb taken c[jb] times, at
// their absolute columns i + jb (lo half) and i + jb + 1 (hi half). With
// c[jb] the number of a fold's steps whose window holds jb this equals,
// bit for bit, the fold's loop of windowed partial products (the limbs
// of each step's window, once a step): uint32 column sums are sums mod
// 2**32, so c copies of a term add c times the term. B limbs of weight 0
// add nothing and are skipped (a test the same for every thread of a
// warp).
template <int M>
__device__ __forceinline__ void ppm_weighted(const uint32_t (&a)[M],
                                             const uint32_t (&b)[M],
                                             const uint32_t (&c)[M],
                                             uint32_t (&acc)[2 * M]) {
#pragma unroll
  for (int jb = 0; jb < M; ++jb) {
    if (c[jb] == 0) continue;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const uint32_t p = a[i] * b[jb];  // exact 16x16 -> 32
      acc[i + jb] += c[jb] * (p & limbs::kMask);
      acc[i + jb + 1] += c[jb] * (p >> limbs::kRadixBits);
    }
  }
}

// Final adder in registers over columns [0, n): canonical 16-bit limbs,
// the carry out of column n-1 dropped (mod 2**(16n)).
template <int W>
__device__ __forceinline__ void carry_pass(uint32_t (&cols)[W], int n) {
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k < n) {
      const uint32_t tot = cols[k] + carry;
      cols[k] = tot & limbs::kMask;
      carry = tot >> limbs::kRadixBits;
    }
  }
}

// The row product of a fold whose tile state is limb weights (bank_fold,
// FB, FF): one weighted schoolbook pass, then one carry pass over
// columns [0, n).
template <int M>
__device__ __forceinline__ void schoolbook(const uint32_t (&a)[M],
                                           const uint32_t (&b)[M],
                                           const uint32_t (&w)[M],
                                           uint32_t (&cols)[2 * M], int n) {
#pragma unroll
  for (int c = 0; c < 2 * M; ++c) cols[c] = 0u;
  ppm_weighted<M>(a, b, w, cols);
  carry_pass<2 * M>(cols, n);
}

// The bulk path: n_inst instances of `rows` rows, rows of L words in a
// and b and 2L in out, walked in tiles of Bulk<L>::kTileRows rows by a
// persistent grid of Bulk<L>::kThreads threads a block (thread t takes
// rows t, t + kThreads, ... of a tile, so a warp's accesses stay
// contiguous). Needs 16-byte-aligned a, b, out, rows * L a multiple of
// 4 (so that every tile's spans are whole 16-byte units) and n_inst *
// tiles an instance below 2**31; `smem` holds Bulk<L>::kBytes bytes.
// Every thread calls fold.warp_weights once a tile.
template <int L, class Fold>
__device__ __forceinline__ void bulk_walk(const uint32_t* __restrict__ a,
                                          const uint32_t* __restrict__ b,
                                          uint32_t* __restrict__ out,
                                          int n_inst, int rows,
                                          uint8_t* smem, const Fold& fold) {
  using B = Bulk<L>;
  constexpr int W = 2 * L, R = B::kRowsPerThread, T = B::kThreads;
  constexpr int kSlots = B::kSlots, stages = B::kStages;
  constexpr int tile_rows = B::kTileRows, stage_words = tile_rows * W;
  const int tid = threadIdx.x;
  const int per_inst = (rows + tile_rows - 1) / tile_rows;
  const int total = n_inst * per_inst;
  const int mine = (int)blockIdx.x < total
                       ? (total - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);  // A then B
  uint32_t* slots = ring + stages * stage_words;       // outputs
  const uint32_t bars = smem_u32(slots + kSlots * stage_words);

  // tile `it` of this block: instance, first row, rows in the tile
  auto tile = [&](int it, int& inst, int& row0, int& n) {
    const int t = (int)blockIdx.x + it * (int)gridDim.x;
    inst = t / per_inst;
    row0 = (t - inst * per_inst) * tile_rows;
    n = min(tile_rows, rows - row0);
  };
  auto issue = [&](int it, int s) {  // one thread: the A and B spans
    int inst, row0, n;
    tile(it, inst, row0, n);
    const size_t first = ((size_t)inst * rows + row0) * L;
    const uint32_t bar = bars + 8u * s;
    const uint32_t dst = smem_u32(ring + s * stage_words);
    mbar_expect_tx(bar, 2u * n * L * 4);
    bulk_load(dst, a + first, n * L * 4, bar);
    bulk_load(dst + tile_rows * L * 4, b + first, n * L * 4, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < min(stages, mine); ++it) issue(it, it);
  }
  __syncthreads();
  int s = 0;
  uint32_t phase = 0;
  for (int it = 0; it < mine; ++it) {
    int inst, row0, n;
    tile(it, inst, row0, n);
    const uint32_t* sa = ring + s * stage_words;
    uint32_t wt[L];  // the state of the tile's instance
    fold.warp_weights(inst, wt);
    mbar_wait(bars + 8u * s, phase);
    uint32_t av[R][L], bv[R][L];
#pragma unroll
    for (int k = 0; k < R; ++k) {  // rows past a ragged tile's end: unread
      if (tid + k * T < n) {
        read_row<L>(sa, tid + k * T, av[k]);
        read_row<L>(sa + tile_rows * L, tid + k * T, bv[k]);
      }
    }
    if constexpr (kSlots > 0) {
      if (tid == 0) bulk_wait_read<kSlots - 1>();
    }
    __syncthreads();  // stage s is read; this tile's output slot is free
    if (tid == 0 && it + stages < mine) issue(it + stages, s);
    const size_t first = (size_t)inst * rows + row0;
    uint32_t* slot = slots + (it & 1) * stage_words;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int r = tid + k * T;
      if (r < n) {
        uint32_t acc[W];
        fold.product(av[k], bv[k], wt, acc, W);
        if constexpr (kSlots == 0) {  // one 16-byte product a row
          reinterpret_cast<uint4*>(out)[first + r] =
              make_uint4(acc[0], acc[1], acc[2], acc[3]);
        } else {
          write_row<W>(slot, r, acc);
        }
      }
    }
    if constexpr (kSlots > 0) {
      fence_async_smem();
      __syncthreads();
      if (tid == 0) bulk_store(out + first * W, smem_u32(slot), n * W * 4);
    }
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
  if (tid == 0) bulk_wait_all();
}

// The per-thread path: tile `k` (rows k*blockDim.x ...) of instance
// `inst`, any widths up to MAXL limbs, any 4-byte alignment. A thread
// loads its row's limbs straight from device memory: a warp's LA loads
// at a stride of LA words fall on the same lines, which L1 serves after
// the first. Products of at most 4 words (MAXL = 2) are stored the same
// way, and such a tile touches no shared memory. Wider ones would leave
// at a stride of LA+LB words, many sectors a warp store, so they go
// through `buf` (blockDim.x rows of pitch(la + lb) words) and out with
// neighbouring threads on neighbouring words.
__host__ __device__ constexpr int pitch(int words) { return words | 1; }

template <int MAXL, class Fold>
__device__ __forceinline__ void coalesced_tile(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    uint32_t* __restrict__ out, int inst, int k, int rows, int la, int lb,
    uint32_t* buf, const Fold& fold) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int row0 = k * T, lo = la + lb;
  const int n = min(T, rows - row0);
  const size_t row = (size_t)inst * rows + row0 + tid;
  const bool live = tid < n;
  uint32_t av[MAXL], bv[MAXL], acc[2 * MAXL], w[MAXL];
  if (live) {
    limbs::load_row<MAXL>(a + row * la, la, av);
    limbs::load_row<MAXL>(b + row * lb, lb, bv);
  }
  fold.weights(inst, w);
  if (live) fold.product(av, bv, w, acc, lo);
  if constexpr (MAXL == 2) {
    if (live) {
#pragma unroll
      for (int col = 0; col < 4; ++col) {
        if (col < lo) out[row * lo + col] = acc[col];
      }
    }
  } else {
    // rows of an odd pitch: a warp writing one column of 32 rows hits
    // 32 distinct banks
    const int p = pitch(lo);
    if (live) {
#pragma unroll
      for (int col = 0; col < 2 * MAXL; ++col) {
        if (col < lo) buf[tid * p + col] = acc[col];
      }
    }
    __syncthreads();
    // word i of the tile's output is column c of row r; a step of T words
    // moves (T / lo, T % lo)
    uint32_t* go = out + (row - tid) * lo;
    const int dr = T / lo, dc = T - dr * lo;
    int r = tid / lo, c = tid - r * lo;
    for (int i = tid; i < n * lo; i += T) {
      go[i] = buf[r * p + c];
      r += dr;
      c += dc;
      if (c >= lo) {
        c -= lo;
        ++r;
      }
    }
  }
}

// Blocks of `kernel` a persistent grid launches at (threads, smem): SMs
// times the blocks an SM holds, at most `per_sm` of them (per_sm < 1: no
// cap). The occupancy is queried once a device and kernel (the first
// query also lifts the kernel's dynamic shared memory limit), so later
// launches, such as one captured in a CUDA graph, make no runtime call
// but cudaGetDevice.
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                            int per_sm, int* blocks) {
  struct Entry {
    const void* fn;
    int device, sms, fit;
  };
  static Entry cache[32];
  static int used = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const Entry* hit = nullptr;
  for (int i = 0; i < (used < 32 ? used : 32); ++i) {
    if (cache[i].fn == fn && cache[i].device == device) {
      hit = &cache[i];
      break;
    }
  }
  if (hit == nullptr) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    int sms = 0, fit = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
    Entry& e = cache[used++ % 32];
    e = Entry{fn, device, sms, fit};
    hit = &e;
  }
  const int fit = per_sm > 0 && per_sm < hit->fit ? per_sm : hit->fit;
  *blocks = hit->sms * fit;
  return cudaSuccess;
}

// The shape of a bulk kernel of L limbs on this device, for reports:
// info = {threads, tile rows, stages, shared bytes, grid blocks}.
template <int L, class Kernel>
cudaError_t bulk_shape(Kernel kernel, int* info) {
  using B = Bulk<L>;
  info[0] = B::kThreads;
  info[1] = B::kTileRows;
  info[2] = B::kStages;
  info[3] = (int)B::kBytes;
  return resident_blocks(kernel, B::kThreads, B::kBytes, B::kPerSm,
                         info + 4);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The launch of a bulk kernel of L limbs over n_inst instances of `rows`
// rows on this device: info = {grid.x, grid.y, threads, dynamic shared
// bytes}, the persistent grid min(tiles, resident blocks). Returns
// cudaErrorInvalidValue where the bulk path does not take the rows (rows
// * L not a multiple of 4, or 2**31 tiles or more). The bulk launchers
// launch what it returns; `*_launch_shape` exports it.
template <int L, class Kernel>
cudaError_t bulk_launch_shape(Kernel kernel, long long n_inst,
                              long long rows, int* info) {
  using B = Bulk<L>;
  const long long total =
      n_inst * ((rows + B::kTileRows - 1) / B::kTileRows);
  if (total >= (1LL << 31) || rows * L % 4) return cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err = resident_blocks(kernel, B::kThreads, B::kBytes,
                                          B::kPerSm, &blocks);
  if (err != cudaSuccess) return err;
  info[0] = (int)(total < blocks ? total : blocks);
  info[1] = 1;
  info[2] = B::kThreads;
  info[3] = (int)B::kBytes;
  return cudaSuccess;
}

// The launch of a per-thread kernel of MAXL limbs (coalesced_tile):
// info = {tiles, n_inst, kTileRows threads, dynamic shared bytes}, one
// block a tile of kTileRows rows of an instance; products wider than 4
// words leave through kTileRows rows of pitch(la + lb) words (at most
// 16,896 B: no attribute needed).
inline void tile_launch_shape(int maxl, int n_inst, int rows, int la, int lb,
                              int* info) {
  info[0] = (rows + kTileRows - 1) / kTileRows;
  info[1] = n_inst;
  info[2] = kTileRows;
  info[3] = maxl == 2 ? 0 : kTileRows * pitch(la + lb) * 4;
}

// A compiled kernel's attributes: info = {registers a thread, local
// (spilled) bytes a thread, static shared bytes, most threads a block}.
template <class Kernel>
cudaError_t attributes(Kernel kernel, int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = attr.maxThreadsPerBlock;
  return cudaSuccess;
}

}  // namespace tiles
