"""Counter-based random numbers (:mod:`.philox`)."""
from .philox import philox4x32, random_u32, random_uniform, random_tokens

__all__ = ["philox4x32", "random_u32", "random_uniform", "random_tokens"]
