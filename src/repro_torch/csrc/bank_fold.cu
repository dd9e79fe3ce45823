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
// order, carrying the accumulator in VMEM scratch between steps. Here
// the instance and row axes become blocks and threads (blockIdx.y is
// the instance, one thread per row), and the step axis becomes a loop
// inside the thread, over the instance's own row of the window table,
// which each thread reads from device memory (no scalar prefetch).
// Only the window's limbs are multiplied: masked limbs add 0, so the
// bits equal the reference's full masked loop. The kernel is templated
// on the operand width bucket so the accumulator stays in registers.
//
// Bound: at the widths of the registry designs (2 to 8 limbs) a row
// moves 4*(2*(LA+LB)) bytes for about 5*LA*LB + 3*(LA+LB) integer ops,
// so memory bytes bound it. The row-per-thread layout reads each row's
// limbs with a stride of LA words across a warp; coalescing it is later
// work.
#include "limbs.cuh"

namespace {

template <int MAXL>
__global__ void bank_fold_kernel(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b,
                                 const int32_t* __restrict__ table,
                                 uint32_t* __restrict__ out, int rows,
                                 int la, int lb, int max_steps) {
  const int inst = blockIdx.y;
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;  // ragged edge of the row axis
  const size_t row = (size_t)inst * rows + r;

  uint32_t av[MAXL], bv[MAXL], acc[2 * MAXL];
  limbs::load_row<MAXL>(a + row * la, la, av);
  limbs::load_row<MAXL>(b + row * lb, lb, bv);
#pragma unroll
  for (int k = 0; k < 2 * MAXL; ++k) acc[k] = 0u;

  // the TPU's sequential step axis: this instance's folded windows
  const int32_t* tbl = table + (size_t)inst * max_steps * 2;
  for (int j = 0; j < max_steps; ++j) {
    limbs::ppm_window<MAXL>(av, bv, tbl[2 * j], tbl[2 * j + 1], acc);
  }
  limbs::carry_store<2 * MAXL>(acc, la + lb, out + row * (la + lb));
}

template <int MAXL>
cudaError_t launch(const uint32_t* a, const uint32_t* b,
                   const int32_t* table, uint32_t* out, int n_inst,
                   int rows, int la, int lb, int max_steps,
                   cudaStream_t stream) {
  const dim3 grid((rows + limbs::kThreads - 1) / limbs::kThreads, n_inst);
  bank_fold_kernel<MAXL><<<grid, limbs::kThreads, 0, stream>>>(
      a, b, table, out, rows, la, lb, max_steps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bank_fold_launch(const void* a, const void* b,
                                const void* table, void* out, int n_inst,
                                int rows, int la, int lb, int max_steps,
                                void* stream) {
  auto* pa = static_cast<const uint32_t*>(a);
  auto* pb = static_cast<const uint32_t*>(b);
  auto* pt = static_cast<const int32_t*>(table);
  auto* po = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (limbs::bucket(la, lb)) {
    case 2: return launch<2>(pa, pb, pt, po, n_inst, rows, la, lb, max_steps, s);
    case 4: return launch<4>(pa, pb, pt, po, n_inst, rows, la, lb, max_steps, s);
    case 8: return launch<8>(pa, pb, pt, po, n_inst, rows, la, lb, max_steps, s);
    default: return launch<16>(pa, pb, pt, po, n_inst, rows, la, lb, max_steps, s);
  }
}
