// int8 x int8 matmul with int32 accumulation and a scaling epilogue.
//
// Replaces the reference package's kernels/int8_matmul/kernel.py
// _matmul_kernel (:24), launched by int8_matmul (:50, pallas_call :67):
//   out[i, j] = cast(float(sum_k x[i, k] * w[k, j]) * sx[i] * sw[j])
// for x (M, K) and w (K, N) int8, both row-major, sx (M,) and sw (N,)
// float32, out (M, N) bfloat16 or float32.
//
// Two kernels; the caller (kernels/int8_matmul/kernel.py kernel_path)
// picks one from (M, K, N, alignment) and passes it as `path`.
//
// 1. int8_wgmma_kernel (paths 1 and 2): every shape with K and N
//    multiples of 16 and 16-byte aligned operands, the strides and
//    addresses TMA takes. Hopper's int8 tensor-core path is wgmma, and
//    for 8-bit types wgmma takes both operands K-major only (no transpose
//    immediates). x (M, K) is K-major; w (K, N) row-major is N-major. Of
//    the two ways round that (transpose w's tile in shared memory for an
//    SS wgmma, or swap the operands), the kernel swaps: it computes
//    out^T = w^T x^T. B = x^T is the x tile exactly as TMA lands it
//    (K-major, 128-byte swizzle), and wgmma's N is the tile's count of x
//    rows; A = w^T (an m64 block is 64 columns of w) comes from
//    registers. That costs no shared-memory writes and no pre-pass over
//    w, and N = 64 fits a decode batch with no padding. w's tile lands
//    N-major; each thread reads pieces of 4 k rows x 4 (or 2) adjacent
//    columns and transposes them with __byte_perm into its A fragments.
//    The 4 columns of a piece feed rows g, g + 8 of two m64 blocks (the 2
//    columns: of one), so A's rows are w's columns in a fixed permutation
//    and each thread's accumulators hold adjacent output columns of a
//    row: the epilogue stores them straight to `out` (4 to 16 bytes a
//    thread, 32 to 128 contiguous bytes a row per warp), with no pass
//    through shared memory. Lanes read their four k rows in an order that
//    depends on t (the lane's k group), so the four k groups of a warp
//    fall on distinct 16-byte chunks of the swizzle: the fragment reads
//    are free of bank conflicts.
//    A producer thread keeps a ring of stages (128 k each) in flight with
//    cp.async.bulk.tensor, one full and one empty mbarrier a stage; its
//    warpgroup hands its registers to the consumers (setmaxnreg);
//    consumer warpgroups wait for a full stage, run 4 x (1 or 2)
//    wgmma.m64nNk32 s8.s8.s32 from it, and release it once the wgmmas
//    that read it have retired. TMA zero-fills the ragged M, N and K
//    edges; the epilogue masks M and N.
//    Path 2, prefill tiles (gemma2-9b's prefill chunk, M = 2048,
//    K = 3584, N = 14336: bound by operations, 2MNK at the int8 peak is
//    0.106 ms): 256 columns of w (two consumer warpgroups of 128) x 128
//    rows of x a block, 4 stages of 48 KB, one block an SM, 232
//    registers a consumer; the 16 x 56 grid runs x tiles fastest, so a
//    wave shares its w columns and all of x in L2.
//    Path 1, decode tiles (M <= 64, e.g. gemma2-9b's decode batch of 64:
//    bound by the bytes of w, 0.016 ms at HBM rate): 64 columns x 64
//    rows a block, one consumer warpgroup, 6 stages of 16 KB, two blocks
//    an SM, so the 224 blocks of N = 14336 all stream w at once on every
//    SM (192 KB in flight an SM). Above M = 64 these tiles would
//    re-read w once per 64 rows, and the prefill tiles are faster.
// 2. int8_matmul_kernel (path 0): every other shape (K or N not a
//    multiple of 16, unaligned operands, K = 0). A block of 8 warps owns a
//    128 x 128 tile and loops over K in steps of 64 with mma.sync.m16n8k32
//    s8 x s8 -> s32; w is transposed in 4 x 4-byte blocks with __byte_perm
//    on its way into shared memory; loads zero-fill and stores mask the
//    ragged edges.
//
// Both use the reference's epilogue order: __int2float_rn(acc), times
// sx[i], times sw[j] (__fmul_rn, no contraction), then
// __float2bfloat16_rn (or the float itself), so either equals the plain
// version bit for bit: the int32 sum is exact in any order.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;              // 8 warps: 2 along M x 4 along N
constexpr int kWords = kBK / 4;            // 32-bit words of k per tile row
constexpr int kStride = kWords + 4;        // padded: fragment loads conflict-free
constexpr int kAWords = kBM * kWords / kThreads;          // 8 a thread
constexpr int kBBlocks = (kBK / 4) * (kBN / 4) / kThreads;  // 2 a thread

// Four consecutive int8 of row `row` at columns col..col+3 as one word,
// zero outside [0, rows) x [0, cols). `vec`: 4-byte loads are aligned.
__device__ __forceinline__ uint32_t load4(const int8_t* __restrict__ p,
                                          long long row, int col,
                                          long long rows, int cols,
                                          long long ld, bool vec) {
  if (row >= rows || col >= cols) return 0u;
  const int8_t* q = p + row * ld + col;
  if (vec && col + 3 < cols) return *reinterpret_cast<const uint32_t*>(q);
  uint32_t v = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (col + e < cols) v |= (uint32_t)(uint8_t)q[e] << (8 * e);
  }
  return v;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(__nv_bfloat16* o, long long idx,
                                       float v0, float v1, bool two,
                                       bool pair) {
  if (pair && two) {
    *reinterpret_cast<__nv_bfloat162*>(o + idx) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  o[idx] = __float2bfloat16_rn(v0);
  if (two) o[idx + 1] = __float2bfloat16_rn(v1);
}

__device__ __forceinline__ void store2(float* o, long long idx, float v0,
                                       float v1, bool two, bool pair) {
  if (pair && two) {
    *reinterpret_cast<float2*>(o + idx) = make_float2(v0, v1);
    return;
  }
  o[idx] = v0;
  if (two) o[idx + 1] = v1;
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   OutT* __restrict__ out, int m, int k, int n, bool vec_x,
                   bool vec_w) {
  __shared__ uint32_t as[kBM][kStride];    // [m][k word]
  __shared__ uint32_t bs[kBN][kStride];    // [n][k word]: w transposed
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;  // mma group and thread in group
  const int wm = warp >> 2, wn = warp & 3;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  uint32_t ra[kAWords], rb[kBBlocks][4];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int t = 0; t < kAWords; ++t) {
      const int q = tid + t * kThreads;
      ra[t] = load4(x, m0 + q / kWords, k0 + 4 * (q % kWords), m, k, k,
                    vec_x);
    }
#pragma unroll
    for (int t = 0; t < kBBlocks; ++t) {
      // 4 x 4-byte block: n group ng (8 lanes along n read 32 contiguous
      // bytes of a w row), k group kg
      const int blk = tid + t * kThreads;
      const int ng = (blk & 7) + 8 * (blk >> 7), kg = (blk >> 3) & 15;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        rb[t][r] = load4(w, k0 + 4 * kg + r, n0 + 4 * ng, k, n, n, vec_w);
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load_tile(0);
  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();  // the previous tile's MMAs are done with as / bs
#pragma unroll
    for (int t = 0; t < kAWords; ++t) {
      const int q = tid + t * kThreads;
      as[q / kWords][q % kWords] = ra[t];
    }
#pragma unroll
    for (int t = 0; t < kBBlocks; ++t) {
      const int blk = tid + t * kThreads;
      const int ng = (blk & 7) + 8 * (blk >> 7), kg = (blk >> 3) & 15;
      // rows r = k, bytes e = n  ->  word for column n: bytes = k 0..3
      const uint32_t t0 = __byte_perm(rb[t][0], rb[t][1], 0x5140);
      const uint32_t t1 = __byte_perm(rb[t][0], rb[t][1], 0x7362);
      const uint32_t t2 = __byte_perm(rb[t][2], rb[t][3], 0x5140);
      const uint32_t t3 = __byte_perm(rb[t][2], rb[t][3], 0x7362);
      bs[4 * ng + 0][kg] = __byte_perm(t0, t2, 0x5410);
      bs[4 * ng + 1][kg] = __byte_perm(t0, t2, 0x7632);
      bs[4 * ng + 2][kg] = __byte_perm(t1, t3, 0x5410);
      bs[4 * ng + 3][kg] = __byte_perm(t1, t3, 0x7632);
    }
    __syncthreads();
    if (k0 + kBK < k) load_tile(k0 + kBK);  // in flight during the MMAs

#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * 64 + i * 16 + g;
        af[i][0] = as[row][8 * ks + tg];
        af[i][1] = as[row + 8][8 * ks + tg];
        af[i][2] = as[row][8 * ks + 4 + tg];
        af[i][3] = as[row + 8][8 * ks + 4 + tg];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + j * 8 + g;
        bf[j][0] = bs[col][8 * ks + tg];
        bf[j][1] = bs[col][8 * ks + 4 + tg];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], bf[j][0],
                 bf[j][1]);
    }
  }

  // epilogue: c0, c1 at (g, 2tg + {0, 1}), c2, c3 at (g + 8, ...)
  const bool pair = (n & 1) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm * 64 + i * 16 + g + 8 * h;
      if (row >= m) continue;
      const float sr = sx[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * tg;
        if (col >= n) continue;
        const bool two = col + 1 < n;
        const float v0 = __fmul_rn(
            __fmul_rn(__int2float_rn(acc[i][j][2 * h]), sr), sw[col]);
        const float v1 = two ? __fmul_rn(__fmul_rn(__int2float_rn(
                                   acc[i][j][2 * h + 1]), sr), sw[col + 1])
                             : 0.f;
        store2(out, row * n + col, v0, v1, two, pair);
      }
    }
  }
}

// The mma.sync launch: one block a 128 x 128 output tile, its shared
// tiles static (info = {grid.x, grid.y, threads, dynamic shared bytes}).
inline void mma_sync_shape(int m, int n, int* info) {
  info[0] = (m + kBM - 1) / kBM;
  info[1] = (n + kBN - 1) / kBN;
  info[2] = kThreads;
  info[3] = 0;
}

template <typename OutT>
cudaError_t launch_mma_sync(const void* x, const void* w, const void* sx,
                            const void* sw, void* out, int m, int k, int n,
                            void* stream) {
  int info[4];
  mma_sync_shape(m, n, info);
  // 4-byte loads need rows that start on 4-byte boundaries
  const bool vec_x = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const bool vec_w = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  int8_matmul_kernel<OutT><<<dim3(info[0], info[1]), info[2], info[3],
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<OutT*>(out), m, k, n, vec_x, vec_w);
  return cudaGetLastError();
}

// ------------------------------------------------- wgmma + TMA kernel

constexpr int kTileK = 128;       // k bytes a stage: one 128-byte x row

// kRows: x rows a tile (wgmma N); kGroups: consumer warpgroups; kSub:
// m64 blocks a warpgroup (its w columns: 64 kSub); kMinBlocks: blocks an
// SM; kConsumerRegs: registers a consumer thread takes from the producer
template <int Rows, int Groups, int Sub, int Stages, int MinBlocks,
          int ConsumerRegs>
struct WgmmaConfig {
  static constexpr int kRows = Rows, kGroups = Groups, kSub = Sub;
  static constexpr int kStages = Stages, kMinBlocks = MinBlocks;
  // + a producer warpgroup, so that setmaxnreg can move its registers
  // to the consumers (it acts on whole warpgroups)
  static constexpr int kThreads = 128 * (kGroups + 1);
  static constexpr int kProducerRegs = 40, kConsumerRegs = ConsumerRegs;
  static constexpr int kWgCols = 64 * kSub;
  static constexpr int kWTileBytes = kTileK * kWgCols;
  static constexpr int kStageBytes = kGroups * kWTileBytes + kRows * kTileK;
  static constexpr int kBarBytes = 2 * kStages * 8;
  // + 1 KB to align the ring to the 128-byte swizzle's 1 KB atom
  static constexpr int kSmem = kStages * kStageBytes + kBarBytes + 1024;
  static constexpr int kCols = kGroups * kWgCols;
  static_assert(kSub == 1 || kSub == 2, "one or two m64 blocks");
  static_assert(kConsumerRegs * kGroups + kProducerRegs <=
                    65536 / 128 / kMinBlocks,
                "setmaxnreg asks for more registers than the SM holds");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
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

// 2-d TMA load of the box at (c0 inner, c1 outer) into shared memory,
// completing `bytes` on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), LBO
// unused by this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// Keep the compiler from moving accesses of an accumulator across the
// asynchronous wgmmas that own it.
template <int kN>
__device__ __forceinline__ void fence_regs(int (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// D (m64 x N, s32) += A (m64 x k32, s8, registers) * B (k32 x N, s8,
// K-major in shared memory).
__device__ __forceinline__ void wgmma_n64(int (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int kRows>
__device__ __forceinline__ void wgmma_rs(int (&d)[kRows / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (kRows == 64) {
    wgmma_n64(d, a, desc_b);
  } else {
    wgmma_n128(d, a, desc_b);
  }
}

__device__ __forceinline__ void store_cols(__nv_bfloat16* o,
                                           const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v[0], v[1]);
}

__device__ __forceinline__ void store_cols(__nv_bfloat16* o,
                                           const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 bits;
  bits.x = *reinterpret_cast<const uint32_t*>(&lo);
  bits.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(o) = bits;
}

__device__ __forceinline__ void store_cols(float* o, const float (&v)[2]) {
  *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
}

__device__ __forceinline__ void store_cols(float* o, const float (&v)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename OutT, typename Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, Cfg::kMinBlocks)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  OutT* __restrict__ out, int m, int k, int n) {
  constexpr int kRows = Cfg::kRows, kGroups = Cfg::kGroups;
  constexpr int kSub = Cfg::kSub, kStages = Cfg::kStages;
  constexpr int kWgCols = Cfg::kWgCols, kWTileBytes = Cfg::kWTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint8_t* ring_ptr = smem_raw + (ring - raw);
  const uint32_t bars = ring + kStages * Cfg::kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * Cfg::kCols;
  const int k_tiles = (k + kTileK - 1) / kTileK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);                // the producer's expect_tx
      mbar_init(empty(s), 4 * kGroups);     // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kGroups) {
    // producer warpgroup: gives up its registers; one thread keeps the
    // ring full
    regs_dec<Cfg::kProducerRegs>();
    if (warp == 4 * kGroups && lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(empty(s), phase ^ 1u);
        const uint32_t stage = ring + s * Cfg::kStageBytes;
        mbar_expect_tx(full(s), Cfg::kStageBytes);
#pragma unroll
        for (int h = 0; h < kGroups; ++h) {
          tma_load(stage + h * kWTileBytes, &wmap, full(s), n0 + h * kWgCols,
                   kt * kTileK);
        }
        tma_load(stage + kGroups * kWTileBytes, &xmap, full(s), kt * kTileK,
                 m0);
        if (++s == kStages) {
          s = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // consumers: warpgroup grp owns w columns n0 + kWgCols grp ..
  regs_inc<Cfg::kConsumerRegs>();
  const int grp = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  // A thread owns the w columns cb .. cb + 2 kSub - 1 of its warpgroup:
  // rows g and g + 8 of each m64 block. It reads them as (2 kSub)-byte
  // pieces of 4 k rows and transposes those with __byte_perm. Lane t
  // reads its 4 k rows in the order step ^ swap, so at every step the
  // warp's 4 k groups sit on rows {0, 4, 2, 6} + step mod 8 of the
  // swizzle, on distinct 16-byte chunks: no bank conflict.
  const int cb = (2 * kSub) * (8 * wi + g);
  const int swap = (t >> 1) << 1;
  uint32_t off[4];
#pragma unroll
  for (int step = 0; step < 4; ++step) {
    const int row = 4 * t + (step ^ swap);
    if constexpr (kSub == 2) {          // 128-byte rows, 128-byte swizzle
      off[step] = row * 128 + (((cb >> 4) ^ (row & 7)) << 4) + (cb & 15);
    } else {                            // 64-byte rows, 64-byte swizzle
      off[step] = row * 64 + (((cb >> 4) ^ ((row >> 1) & 3)) << 4) +
                  (cb & 15);
    }
  }
  // second transpose stage, with the two row pairs in swapped order
  const uint32_t sel_even = swap ? 0x1054u : 0x5410u;
  const uint32_t sel_odd = swap ? 0x3276u : 0x7632u;

  constexpr int kAcc = kRows / 2;            // s32 a thread an m64 block
  int acc[kSub][kAcc];
#pragma unroll
  for (int b = 0; b < kSub; ++b) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[b][i] = 0;
    fence_regs(acc[b]);
  }

  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    mbar_wait(full(s), phase);
    const uint8_t* wt = ring_ptr + s * Cfg::kStageBytes + grp * kWTileBytes;
    const uint32_t xt = ring + s * Cfg::kStageBytes + kGroups * kWTileBytes;
#pragma unroll
    for (int ks = 0; ks < kTileK / 32; ++ks) {
      // A fragments: block b's rows g, g + 8 are columns cb + 2b, + 1;
      // registers 0, 1 hold k 4t..4t+3, registers 2, 3 k 16+4t..16+4t+3
      uint32_t a[kSub][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint8_t* rows = wt + (32 * ks + 16 * q) * kWgCols;
        uint32_t v[4];
#pragma unroll
        for (int step = 0; step < 4; ++step) {
          v[step] = kSub == 2
              ? *reinterpret_cast<const uint32_t*>(rows + off[step])
              : *reinterpret_cast<const uint16_t*>(rows + off[step]);
        }
        // bytes (k, column): lo = columns 0, 1 of two k rows, hi = 2, 3
        const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140);
        const uint32_t lo23 = __byte_perm(v[2], v[3], 0x5140);
        a[0][2 * q] = __byte_perm(lo01, lo23, sel_even);      // column 0
        a[0][2 * q + 1] = __byte_perm(lo01, lo23, sel_odd);   // column 1
        if constexpr (kSub == 2) {
          const uint32_t hi01 = __byte_perm(v[0], v[1], 0x7362);
          const uint32_t hi23 = __byte_perm(v[2], v[3], 0x7362);
          a[kSub - 1][2 * q] = __byte_perm(hi01, hi23, sel_even);
          a[kSub - 1][2 * q + 1] = __byte_perm(hi01, hi23, sel_odd);
        }
      }
      wgmma_fence();
      const uint64_t desc_b = sw128_desc(xt + 32 * ks);
#pragma unroll
      for (int b = 0; b < kSub; ++b) wgmma_rs<kRows>(acc[b], a[b], desc_b);
      wgmma_commit();
      wgmma_wait<1>();     // the previous k32 step's wgmmas have retired
      if (ks == 0 && kt > 0 && lane == 0) mbar_arrive(empty(prev));
    }
    prev = s;
    if (++s == kStages) {
      s = 0;
      phase ^= 1u;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < kSub; ++b) fence_regs(acc[b]);

  // epilogue: acc[b][4j + 2h + e] is output row m0 + 8j + 2t + e, column
  // nb + 2b + h: a thread holds 2 kSub adjacent columns of each of its
  // rows and stores them with one 4- to 16-byte store
  const int nb = n0 + grp * kWgCols + cb;
  if (nb >= n) return;                     // n % 16 == 0: all or none
  float scol[2 * kSub];
#pragma unroll
  for (int c = 0; c < 2 * kSub; ++c) scol[c] = sw[nb + c];
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * j + 2 * t + e;
      if (row >= m) continue;
      const float sr = sx[row];
      float v[2 * kSub];
#pragma unroll
      for (int c = 0; c < 2 * kSub; ++c) {
        const int sum = acc[c >> 1][4 * j + 2 * (c & 1) + e];
        v[c] = __fmul_rn(__fmul_rn(__int2float_rn(sum), sr), scol[c]);
      }
      store_cols(out + static_cast<long long>(row) * n + nb, v);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; the library links only the
// runtime, so it is looked up through the runtime once.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A row-major (outer, inner) int8 matrix, boxes of (box_outer, box_inner)
// in the 64- or 128-byte swizzle; out-of-bounds elements load as zero.
bool tensor_map(CUtensorMap* map, const void* ptr, int inner, int outer,
                int box_inner, int box_outer, int swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The wgmma launch of Cfg's tiles: info = {grid.x, grid.y, threads,
// dynamic shared bytes}; cudaErrorInvalidValue where TMA cannot load the
// shape (row strides of K and N bytes in multiples of 16, K > 0).
template <typename Cfg>
cudaError_t wgmma_shape(int m, int k, int n, int* info) {
  if (k <= 0 || k % 16 || n % 16) return cudaErrorInvalidValue;
  info[0] = (m + Cfg::kRows - 1) / Cfg::kRows;
  info[1] = (n + Cfg::kCols - 1) / Cfg::kCols;
  info[2] = Cfg::kThreads;
  info[3] = Cfg::kSmem;
  return cudaSuccess;
}

template <typename OutT, typename Cfg>
cudaError_t launch_wgmma(const void* x, const void* w, const void* sx,
                         const void* sw, void* out, int m, int k, int n,
                         void* stream) {
  // TMA: row strides and base addresses in multiples of 16 bytes
  int info[4];
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      wgmma_shape<Cfg>(m, k, n, info) != cudaSuccess) {
    return cudaErrorInvalidValue;
  }
  auto kernel = int8_wgmma_kernel<OutT, Cfg>;
  // the dynamic shared memory above 48 KB, once a device (so that a launch
  // captured in a CUDA graph makes no other runtime call)
  static uint64_t configured = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!(configured >> device & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
    if (err != cudaSuccess) return err;
    configured |= 1ull << device;
  }
  CUtensorMap xmap, wmap;
  // x rows are 128 bytes, w tile rows kWgCols: each swizzled in full
  if (!tensor_map(&xmap, x, k, m, kTileK, Cfg::kRows, 128) ||
      !tensor_map(&wmap, w, n, k, Cfg::kWgCols, kTileK, Cfg::kWgCols)) {
    return cudaErrorInvalidValue;
  }
  kernel<<<dim3(info[0], info[1]), info[2], info[3],
           static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<OutT*>(out), m, k, n);
  return cudaGetLastError();
}

// path 1: decode tiles; path 2: prefill tiles (see the note at the top)
using DecodeConfig = WgmmaConfig<64, 1, 1, 6, 2, 216>;
using PrefillConfig = WgmmaConfig<128, 2, 2, 4, 1, 232>;

template <typename OutT>
cudaError_t launch(int path, const void* x, const void* w, const void* sx,
                   const void* sw, void* out, int m, int k, int n,
                   void* stream) {
  switch (path) {
    case 0:
      return launch_mma_sync<OutT>(x, w, sx, sw, out, m, k, n, stream);
    case 1:
      return launch_wgmma<OutT, DecodeConfig>(x, w, sx, sw, out, m, k, n,
                                              stream);
    case 2:
      return launch_wgmma<OutT, PrefillConfig>(x, w, sx, sw, out, m, k, n,
                                               stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename OutT>
cudaError_t kernel_attributes(int path, cudaFuncAttributes* attr) {
  switch (path) {
    case 0:
      return cudaFuncGetAttributes(
          attr, reinterpret_cast<const void*>(int8_matmul_kernel<OutT>));
    case 1:
      return cudaFuncGetAttributes(
          attr, reinterpret_cast<const void*>(
                    int8_wgmma_kernel<OutT, DecodeConfig>));
    case 2:
      return cudaFuncGetAttributes(
          attr, reinterpret_cast<const void*>(
                    int8_wgmma_kernel<OutT, PrefillConfig>));
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (m, k), w (k, n) int8; sx (m,), sw (n,) float32; out (m, n): bfloat16
// when out_bf16 is 1, else float32. All contiguous. path: 0 the mma.sync
// kernel, 1 and 2 the wgmma kernel's decode and prefill tiles.
extern "C" int int8_matmul_launch(const void* x, const void* w,
                                  const void* sx, const void* sw, void* out,
                                  int m, int k, int n, int out_bf16, int path,
                                  void* stream) {
  if (out_bf16) {
    return launch<__nv_bfloat16>(path, x, w, sx, sw, out, m, k, n, stream);
  }
  return launch<float>(path, x, w, sx, sw, out, m, k, n, stream);
}

// Dynamic shared memory a block of `path` asks for (0: static only).
extern "C" int int8_matmul_smem(int path) {
  return path == 1 ? DecodeConfig::kSmem
                   : path == 2 ? PrefillConfig::kSmem : 0;
}

// The launch int8_matmul_launch makes for these arguments, and the
// attributes of the kernel it launches: info = {grid.x, grid.y, threads,
// dynamic shared bytes} and {registers, local bytes, static shared
// bytes, most threads a block} (the launch contract of
// kernels/int8_matmul/ops.py is held to them).
extern "C" int int8_matmul_launch_shape(int m, int k, int n, int out_bf16,
                                        int path, int* info) {
  switch (path) {
    case 0: mma_sync_shape(m, n, info); return cudaSuccess;
    case 1: return wgmma_shape<DecodeConfig>(m, k, n, info);
    case 2: return wgmma_shape<PrefillConfig>(m, k, n, info);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int int8_matmul_attributes(int m, int k, int n, int out_bf16,
                                      int path, int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = out_bf16
                              ? kernel_attributes<__nv_bfloat16>(path, &attr)
                              : kernel_attributes<float>(path, &attr);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = attr.maxThreadsPerBlock;
  return cudaSuccess;
}
