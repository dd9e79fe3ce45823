// Parallel-prefix final adder: carry-save columns -> canonical limbs.
//
// Replaces the reference package's kernels/prefix_adder/kernel.py
// _adder_kernel (:29), launched by prefix_final_adder (:56, pallas_call
// :68): (B, W) carry-save columns -> (B, W) canonical 16-bit limbs, mod
// 2**(16W). The columns arrive as int64 words (the port's column dtype)
// holding uint32 values; the kernel reads their low 32 bits.
//
// Same arithmetic as the TPU kernel: one split pass folds each column's
// high half into the next limb (limbs < 2**17, the top high half is
// dropped), then Kogge-Stone rounds over (generate, propagate) bits
// resolve every ripple carry in ceil(log2 W) steps.
//
// Design. The TPU kernel shifts a whole (tile, W) block per round. Here a
// segment of S lanes owns one row, S the power of two >= W (at most 32):
// lane k of the segment holds column k, and for W > 32 also column k+32.
// A warp holds 32/S rows, so it reads a contiguous span of rows with
// coalesced loads, and each round is one __shfl_up_sync inside the
// segment: the log depth stays.
//
// Bound: bytes. A row moves 12W bytes (8 in, 4 out) against about
// 10 + 4 log2(W) integer operations per column.
#include "limbs.cuh"

namespace {

using limbs::kMask;
using limbs::kRadixBits;

constexpr int kBlock = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Value of column k-s for the columns this lane holds (k = sl and, with
// TWO, k = sl + 32), zero below column 0. Every lane of the warp runs
// every shuffle; the selects come after.
template <bool TWO>
__device__ __forceinline__ void prev(uint32_t v0, uint32_t v1, int s,
                                     int sl, int seg, uint32_t& p0,
                                     uint32_t& p1) {
  if (s < 32) {
    const uint32_t up0 = __shfl_up_sync(kFull, v0, s, seg);
    p0 = sl >= s ? up0 : 0u;
    if (TWO) {  // seg == 32: column sl+32-s lies in word 0 when sl < s
      const uint32_t up1 = __shfl_up_sync(kFull, v1, s);
      const uint32_t wrap = __shfl_sync(kFull, v0, (sl - s) & 31);
      p1 = sl >= s ? up1 : wrap;
    }
  } else {  // s == 32, TWO only: column sl+32-32 is this lane's word 0
    p0 = 0u;
    p1 = v0;
  }
}

template <bool TWO>
__global__ void prefix_adder_kernel(const int64_t* __restrict__ cols,
                                    uint32_t* __restrict__ out,
                                    long long bsz, int w, int seg) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int sl = threadIdx.x & (seg - 1);  // column within the segment
  const long long row = t / seg;
  // whole warps stay for the shuffles; rows past the end load zeros
  const bool live = row < bsz;
  const long long base = live ? row * w : 0;
  const uint32_t c0 = (live && sl < w) ? (uint32_t)cols[base + sl] : 0u;
  const uint32_t c1 =
      (TWO && live && sl + 32 < w) ? (uint32_t)cols[base + sl + 32] : 0u;

  // phase 1: limb[k] = digit[k] + high[k-1], each < 2**17
  uint32_t h0, h1 = 0u;
  prev<TWO>(c0 >> kRadixBits, c1 >> kRadixBits, 1, sl, seg, h0, h1);
  const uint32_t l0 = (c0 & kMask) + h0;
  const uint32_t l1 = (c1 & kMask) + h1;
  uint32_t g0 = l0 >> kRadixBits, g1 = l1 >> kRadixBits;
  uint32_t p0 = (l0 & kMask) == kMask, p1 = (l1 & kMask) == kMask;

  // phase 2: Kogge-Stone, (g, p) o (g', p') with shifts 1, 2, 4, ...
  for (int s = 1; s < w; s <<= 1) {
    uint32_t gp0, gp1 = 0u, pp0, pp1 = 0u;
    prev<TWO>(g0, g1, s, sl, seg, gp0, gp1);
    prev<TWO>(p0, p1, s, sl, seg, pp0, pp1);
    g0 |= p0 & gp0;
    p0 &= pp0;
    g1 |= p1 & gp1;
    p1 &= pp1;
  }
  // carry INTO column k = combined generate of columns < k
  uint32_t ci0, ci1 = 0u;
  prev<TWO>(g0, g1, 1, sl, seg, ci0, ci1);
  if (live && sl < w) out[base + sl] = ((l0 & kMask) + ci0) & kMask;
  if (TWO && live && sl + 32 < w) {
    out[base + sl + 32] = ((l1 & kMask) + ci1) & kMask;
  }
}

// Lanes a row: the power of two >= w, at most 32.
inline int segment(int w) {
  int seg = 1;
  while (seg < w && seg < 32) seg <<= 1;
  return seg;
}

}  // namespace

// The launch of a (bsz, w) row block: info = {grid.x, grid.y, threads,
// dynamic shared bytes}, a segment of lanes a row (prefix_adder_launch
// launches what it returns).
extern "C" int prefix_adder_launch_shape(int bsz, int w, int* info) {
  const long long threads = (long long)bsz * segment(w);
  info[0] = (int)((threads + kBlock - 1) / kBlock);
  info[1] = 1;
  info[2] = kBlock;
  info[3] = 0;
  return cudaSuccess;
}

// The attributes of the kernel a launch of width w runs: info =
// {registers, local bytes, static shared bytes, most threads a block}.
extern "C" int prefix_adder_attributes(int bsz, int w, int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, reinterpret_cast<const void*>(
                 w > 32 ? prefix_adder_kernel<true>
                        : prefix_adder_kernel<false>));
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = attr.maxThreadsPerBlock;
  return cudaSuccess;
}

// cols: (bsz, w) int64; out: (bsz, w) uint32 limbs; 1 <= w <= 64.
extern "C" int prefix_adder_launch(const void* cols, void* out, int bsz,
                                   int w, void* stream) {
  int info[4];
  prefix_adder_launch_shape(bsz, w, info);
  const int seg = segment(w);
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<const int64_t*>(cols);
  auto* o = static_cast<uint32_t*>(out);
  if (w > 32) {
    prefix_adder_kernel<true><<<info[0], info[2], info[3], s>>>(c, o, bsz, w,
                                                              seg);
  } else {
    prefix_adder_kernel<false><<<info[0], info[2], info[3], s>>>(c, o, bsz,
                                                               w, seg);
  }
  return cudaGetLastError();
}
