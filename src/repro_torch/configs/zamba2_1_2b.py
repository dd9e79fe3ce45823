"""Zamba2-1.2B: Mamba2 stack + ONE shared attention block reused over
depth. [arXiv:2411.15242; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    shared_attn_every=6,
    rope_theta=10_000.0,
)
