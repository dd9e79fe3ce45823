// int8 x int8 matmul with int32 accumulation and a scaling epilogue.
//
// Replaces the reference package's kernels/int8_matmul/kernel.py
// _matmul_kernel (:24), launched by int8_matmul (:50, pallas_call :67):
//   out[i, j] = cast(float(sum_k x[i, k] * w[k, j]) * sx[i] * sw[j])
// for x (M, K) and w (K, N) int8, both row-major, sx (M,) and sw (N,)
// float32, out (M, N) bfloat16 or float32.
//
// Design. The TPU grid (i, j, k) runs its k axis in order, the int32
// accumulator in VMEM scratch. Here a block of 8 warps owns a 128 x 128
// output tile and loops over K in steps of 64; the accumulators live in
// registers (each warp a 64 x 32 sub-tile, 64 int32 a thread), and the
// products are tensor-core mma.sync.m16n8k32 s8 x s8 -> s32. The B operand
// of that instruction wants k contiguous for each n, while w is (K, N)
// row-major, so each w tile is transposed in 4 x 4-byte blocks with
// __byte_perm on its way into shared memory. The next tile's global loads
// are issued before the current tile's MMAs, so they overlap. Ragged M, N
// and K edges are zero-filled on load and masked on store: every shape
// runs here (the reference drops to its plain version for shapes that are
// not a multiple of its blocks).
//
// Epilogue in the reference's order: __int2float_rn(acc), times sx[i],
// times sw[j] (__fmul_rn, no contraction), then __float2bfloat16_rn (or
// the float itself), so the kernel equals its plain version bit for bit:
// the int32 sum is exact in both.
//
// Bound: at the gemma2-9b MLP up-projection (K = 3584, N = 14336) with
// M = 2048 the tensor-core operations (2MNK over the int8 peak); with
// M = 64 the bytes of w.
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

template <typename OutT>
cudaError_t launch(const void* x, const void* w, const void* sx,
                   const void* sw, void* out, int m, int k, int n,
                   void* stream) {
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  // 4-byte loads need rows that start on 4-byte boundaries
  const bool vec_x = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const bool vec_w = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  int8_matmul_kernel<OutT><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<OutT*>(out), m, k, n, vec_x, vec_w);
  return cudaGetLastError();
}

}  // namespace

// x (m, k), w (k, n) int8; sx (m,), sw (n,) float32; out (m, n): bfloat16
// when out_bf16 is 1, else float32. All contiguous.
extern "C" int int8_matmul_launch(const void* x, const void* w,
                                  const void* sx, const void* sw, void* out,
                                  int m, int k, int n, int out_bf16,
                                  void* stream) {
  if (out_bf16) {
    return launch<__nv_bfloat16>(x, w, sx, sw, out, m, k, n, stream);
  }
  return launch<float>(x, w, sx, sw, out, m, k, n, stream);
}
