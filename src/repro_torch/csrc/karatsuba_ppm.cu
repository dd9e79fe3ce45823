// Combinational (spatial) one-level Karatsuba multiply, paper Fig. 4.
//
// Replaces the reference package's kernels/karatsuba_ppm/kernel.py
// _kara_kernel (:46), launched by karatsuba_ppm_mul (:86, pallas_call
// :97): (B, N) x (B, N) -> (B, 2N) canonical limbs, N even.
//
// Same arithmetic as the TPU kernel, step for step:
//   T0 = A0*B0 and T1 = A1*B1 on H = N/2 limbs, T2 = (A0+A1)*(B0+B1) on
//   H+1 limbs, each a schoolbook PPM followed by a carry pass truncated
//   to its width (2H, 2H and 2H+2 limbs);
//   placement on 2N columns: +T0, +T1<<2H, +T2<<H keeping
//   min(2H+2, 2N-H) columns of T2 (at N = 2 T2's top column, always 0,
//   is dropped), and the two complements -(T0+T1)<<H as the columns
//   2*MASK - (t0+t1) in [H, 3H) and 2*MASK elsewhere (t0+t1 <= 2*MASK,
//   so no column wraps), plus 2 in column 0;
//   one carry pass over the 2N columns, the carry out dropped.
//
// Design. The TPU kernel runs a (tile, N) block per grid step. Here one
// thread owns one row (multiplication): the kernel is templated on N so
// every limb array lives in registers with compile-time indices, as in
// mcim_fold.cu; rows are independent threads and blocks, the ragged edge
// masked.
//
// Bound: at 8 and 16 limbs integer operations and bytes are of the same
// order (16N bytes a row against about 15H^2 + 64H operations): bytes
// bind at N = 8, operations at N = 16. The row-per-thread layout reads
// rows with a stride of N words across a warp.
#include "limbs.cuh"

namespace {

using limbs::kMask;
using limbs::kRadixBits;

// Carry-propagate W columns in place, truncated to W limbs.
template <int W>
__device__ __forceinline__ void carry_pass(uint32_t (&c)[W]) {
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const uint32_t tot = c[k] + carry;
    c[k] = tot & kMask;
    carry = tot >> kRadixBits;
  }
}

// Schoolbook PPM of L x L limbs into 2L columns, then its carry pass.
template <int L>
__device__ __forceinline__ void ppm_1ca(const uint32_t (&x)[L],
                                        const uint32_t (&y)[L],
                                        uint32_t (&t)[2 * L]) {
#pragma unroll
  for (int k = 0; k < 2 * L; ++k) t[k] = 0u;
#pragma unroll
  for (int j = 0; j < L; ++j) {
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const uint32_t p = x[i] * y[j];  // exact 16x16 -> 32
      t[i + j] += p & kMask;
      t[i + j + 1] += p >> kRadixBits;
    }
  }
  carry_pass<2 * L>(t);
}

template <int N>
__global__ void karatsuba_ppm_kernel(const uint32_t* __restrict__ a,
                                     const uint32_t* __restrict__ b,
                                     uint32_t* __restrict__ out, int bsz) {
  constexpr int H = N / 2, HP = H + 1, W = 2 * N;
  constexpr int kTake2 = 2 * HP < W - H ? 2 * HP : W - H;
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= bsz) return;
  uint32_t a0[H], a1[H], b0[H], b1[H], sa[HP], sb[HP];
#pragma unroll
  for (int k = 0; k < H; ++k) {
    a0[k] = a[r * N + k];
    a1[k] = a[r * N + H + k];
    b0[k] = b[r * N + k];
    b1[k] = b[r * N + H + k];
  }
  // (A0+A1), (B0+B1) normalized to H+1 limbs
#pragma unroll
  for (int k = 0; k < H; ++k) {
    sa[k] = a0[k] + a1[k];
    sb[k] = b0[k] + b1[k];
  }
  sa[H] = 0u;
  sb[H] = 0u;
  carry_pass<HP>(sa);
  carry_pass<HP>(sb);

  // the three PPM passes
  uint32_t t0[2 * H], t1[2 * H], t2[2 * HP];
  ppm_1ca<H>(a0, b0, t0);
  ppm_1ca<H>(a1, b1, t1);
  ppm_1ca<HP>(sa, sb, t2);

  // 10:2-compressor placement and the two complements
  uint32_t acc[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    uint32_t v = c < 2 * H ? t0[c] : t1[c - 2 * H];
    if (c >= H && c - H < kTake2) v += t2[c - H];
    const uint32_t neg =
        (c >= H && c - H < 2 * H) ? 2 * kMask - (t0[c - H] + t1[c - H])
                                  : 2 * kMask;
    acc[c] = v + neg;
  }
  acc[0] += 2u;  // +1 +1 for the two complements
  carry_pass<W>(acc);
  uint32_t* dst = out + r * W;
#pragma unroll
  for (int c = 0; c < W; ++c) dst[c] = acc[c];
}

template <int N>
cudaError_t launch(const void* a, const void* b, void* out, int bsz,
                   void* stream) {
  karatsuba_ppm_kernel<N>
      <<<(bsz + limbs::kThreads - 1) / limbs::kThreads, limbs::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
          static_cast<uint32_t*>(out), bsz);
  return cudaGetLastError();
}

}  // namespace

// a, b: (bsz, n) limbs; out: (bsz, 2n) limbs; n even, 2 <= n <= 16.
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
