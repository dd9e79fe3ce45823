from .kernel import int8_matmul, int8_matmul_ref
from .ops import quantized_matmul, quantize_rows

__all__ = ["int8_matmul", "int8_matmul_ref", "quantized_matmul",
           "quantize_rows"]
