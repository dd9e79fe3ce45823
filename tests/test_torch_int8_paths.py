"""Which kernel of ``csrc/int8_matmul.cu`` takes an int8 product.

The choice is a plain function of (M, K, N, alignment), so it is held
here on the CPU; ``tests/test_torch_kernels.py`` runs every path on the
card against the plain version.
"""
import pytest
import torch

from repro_torch.kernels import int8_matmul as TI

GEMMA_K, GEMMA_N = 3584, 14336          # gemma2-9b MLP up-projection


@pytest.mark.parametrize("m,k,n,aligned,path", [
    (2048, GEMMA_K, GEMMA_N, True, "wgmma_prefill"),   # prefill chunk
    (64, GEMMA_K, GEMMA_N, True, "wgmma_decode"),      # decode batch
    (1, GEMMA_K, GEMMA_N, True, "wgmma_decode"),
    (65, GEMMA_K, GEMMA_N, True, "wgmma_prefill"),     # two row tiles
    (2048, 3590, GEMMA_N, True, "mma_sync"),           # K % 16 != 0
    (64, GEMMA_K, 14344, True, "mma_sync"),            # N % 16 != 0
    (2048, GEMMA_K, GEMMA_N, False, "mma_sync"),       # unaligned operand
    (64, 0, 64, True, "mma_sync"),                     # K = 0
    (128, 128, 4096, True, "wgmma_prefill"),
    (2048, 3584, 512, True, "wgmma_prefill"),
    (33, 70, 45, True, "mma_sync"),
    (256, 3600, 256, True, "wgmma_prefill"),           # K % 128 != 0
    (48, 3600, 256, True, "wgmma_decode"),
])
def test_kernel_path_by_shape(m, k, n, aligned, path):
    assert TI.kernel_path(m, k, n, aligned) == path
    assert path in TI.PATHS


def _operands(m, k, n):
    gen = torch.Generator().manual_seed(m * k + n)
    x = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    return x, w, torch.rand(m, generator=gen), torch.rand(n, generator=gen)


@pytest.mark.parametrize("path", ("wgmma_decode", "wgmma_prefill"))
def test_wgmma_paths_refuse_shapes_tma_cannot_load(path):
    with pytest.raises(ValueError, match="TMA"):
        TI.int8_matmul_kernel(*_operands(33, 70, 45), path=path)


def test_kernel_launch_refuses_unknown_path_and_cpu_tensors():
    args = _operands(16, 32, 16)
    with pytest.raises(ValueError, match="path"):
        TI.int8_matmul_kernel(*args, path="cublas")
    with pytest.raises(ValueError, match="not CUDA"):
        TI.int8_matmul_kernel(*args, path="wgmma_decode")
