from .kernel import (prefix_adder_kernel, prefix_final_adder,
                     prefix_final_adder_ref)
from .ops import fast_final_adder, launch_contract

__all__ = ["prefix_final_adder", "prefix_final_adder_ref", "fast_final_adder",
           "prefix_adder_kernel", "launch_contract"]
