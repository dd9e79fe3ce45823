"""The NVIDIA H100 SXM's figures, the one home of every bound the port
computes: the plan-time gate's roofline (:mod:`.kernels.introspect`),
the bulk kernels' persistent grids (:mod:`.kernels._row_tiles`), the dry
run's roofline (:mod:`.launch.roofline`) and ``chip_smoke.py``'s bounds.
It imports nothing, so any module may import it.

Sources: NVIDIA's H100 SXM5 data sheet (dense rates at the full 700 W
power limit) and the CUDA C Programming Guide's throughput table for
compute capability 9.0 (64 int32 add/logic/shift/IMAD results per clock
per SM at the 1.98 GHz boost clock).  ``portbench/roofline.py`` keeps
the benchmark's own frozen copy.
"""

#: streaming multiprocessors
SMS = 132
#: HBM3 bandwidth, bytes a second
HBM_BYTES_PER_S = 3.35e12
#: int32 operations a second
INT32_OPS_PER_S = SMS * 64 * 1.98e9
#: dense int8 tensor-core operations a second
INT8_TC_OPS_PER_S = 1.979e15
#: dense bf16 tensor-core FLOP a second
BF16_FLOPS_PER_S = 989e12
#: shared memory a block may opt in to (227 KiB; ``tiles::kSmemLimit``
#: of ``csrc/row_tiles.cuh``)
SMEM_OPTIN_BYTES = 232448
