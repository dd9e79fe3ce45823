"""Bit-exact deterministic reductions (:mod:`.fixedpoint`)."""
from .fixedpoint import (f32_to_fixed, fixed_to_f32, exact_sum, exact_psum,
                         exact_tree_sum, N_LIMBS, FRAC_BITS)

__all__ = ["f32_to_fixed", "fixed_to_f32", "exact_sum", "exact_psum",
           "exact_tree_sum", "N_LIMBS", "FRAC_BITS"]
