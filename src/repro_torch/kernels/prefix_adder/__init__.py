from .kernel import prefix_final_adder, prefix_final_adder_ref
from .ops import fast_final_adder

__all__ = ["prefix_final_adder", "prefix_final_adder_ref", "fast_final_adder"]
