"""Public quantize / matmul / dequantize ops built on the int8 kernel."""
from __future__ import annotations

import torch

from .kernel import PATHS, int8_matmul, int8_matmul_ref, kernel_path

#: (x rows, w columns) of an output tile and threads a block of each
#: kernel of ``csrc/int8_matmul.cu``; its dynamic and static shared bytes
TILES = {"mma_sync": ((128, 128), 256, 0, 2 * 128 * (64 // 4 + 4) * 4),
         "wgmma_decode": ((64, 64), 256, 6 * (128 * 64 + 64 * 128)
                          + 2 * 6 * 8 + 1024, 0),
         "wgmma_prefill": ((128, 256), 384, 4 * (2 * 128 * 128
                                                 + 128 * 128)
                           + 2 * 4 * 8 + 1024, 0)}


def launch_contract(m: int = 256, k: int = 512, n: int = 256,
                    out_dtype=torch.bfloat16):
    """Static :class:`~repro_torch.kernels.introspect.LaunchContract`.

    One int8 matmul launch of (M, K) @ (K, N) on the kernel
    :func:`.kernel.kernel_path` picks for aligned operands: a block an
    output tile, the K fold inside it.  The shared-memory model is the
    kernel's tiles: the wgmma ring of stages (w and x tiles of 128 K
    bytes, two mbarriers a stage, 1 KB of alignment) or the mma.sync
    kernel's two static tiles of 128 rows of K words (padded by 4).
    """
    from repro_torch.kernels import introspect
    path = kernel_path(m, k, n, True)
    tile, _, _, static = TILES[path]
    out = "bfloat16" if out_dtype == torch.bfloat16 else "float32"
    kernel = "int8_matmul_launch"
    args = (m, k, n, int(out == "bfloat16"), PATHS.index(path))
    grid, block, dynamic = introspect.launch_shape(kernel, args)
    return introspect.LaunchContract(
        name=f"int8_matmul[m={m},k={k},n={n},{path}]", kernel=kernel,
        lib="int8_matmul", path=path, grid=grid, block=block,
        smem_bytes=dynamic, smem_model_bytes=dynamic + static,
        launch_args=args,
        operands={"x": introspect.Operand((m, k), "int8"),
                  "w": introspect.Operand((k, n), "int8"),
                  "sx": introspect.Operand((m,), "float32"),
                  "sw": introspect.Operand((n,), "float32")},
        outputs={"out": introspect.Operand((m, n), out)},
        meta={"walk": "matmul", "tile": tile, "static_smem": static,
              "ops": 2 * m * k * n, "ops_kind": "int8"})


def quantize_rows(x: torch.Tensor, axis: int = -1):
    """Symmetric per-row int8 quantization along ``axis``: (q, scale).

    Plain PyTorch, as in the reference (no kernel there either);
    ``torch.round`` rounds half to even like ``jnp.round``.  The scale
    divides by a tensor on ``x``'s device: CUDA divides by a CPU scalar
    as a multiply by its reciprocal, which can round otherwise.
    """
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax == 0, 1.0, amax / amax.new_tensor(127.0))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(axis)


def quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                     use_kernel: bool = True, block: int = 128
                     ) -> torch.Tensor:
    """bf16/f32 (M, K) @ (K, N) through int8 with per-row/col scales.

    Every shape goes to :func:`int8_matmul` (the CUDA kernel on the
    card); ``use_kernel=False`` asks for the plain version on any device.
    """
    qx, sx = quantize_rows(x, axis=1)          # per-row of x
    qw, sw = quantize_rows(w, axis=0)          # per-col of w
    if not use_kernel:
        return int8_matmul_ref(qx, qw, sx, sw)
    return int8_matmul(qx, qw, sx, sw, block_m=block, block_n=block,
                       block_k=block)
