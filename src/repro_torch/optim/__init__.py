"""Optimizer-side utilities of the port (so far: int8 gradient
compression)."""
from . import compress

__all__ = ["compress"]
