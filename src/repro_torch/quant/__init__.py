"""Int8 serving/compression built on the int8 matmul kernel."""
from ..kernels.int8_matmul import quantized_matmul, quantize_rows

__all__ = ["quantized_matmul", "quantize_rows"]
