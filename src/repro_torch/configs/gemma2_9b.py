"""Gemma2-9B: alternating local/global attention, logit softcaps.
[arXiv:2408.00118; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    local_per_global=1, window=4096,
    attn_logit_cap=50.0, final_logit_cap=30.0,
    rope_theta=10_000.0, tie_embeddings=True,
)
