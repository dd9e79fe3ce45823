"""Gemma3-1B: 5:1 local:global attention, 128k ctx, qk-norm.
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    qk_norm=True, local_per_global=5, window=512,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    tie_embeddings=True,
)
