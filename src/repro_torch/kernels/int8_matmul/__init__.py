from .kernel import (PATHS, int8_matmul, int8_matmul_kernel, int8_matmul_ref,
                     kernel_path)
from .ops import launch_contract, quantized_matmul, quantize_rows

__all__ = ["PATHS", "int8_matmul", "int8_matmul_kernel", "int8_matmul_ref",
           "kernel_path", "quantized_matmul", "quantize_rows",
           "launch_contract"]
