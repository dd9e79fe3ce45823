"""Checksummed, async checkpoints in the JAX package's layout
(:mod:`.manager`)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
