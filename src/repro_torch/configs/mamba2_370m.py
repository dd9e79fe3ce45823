"""Mamba2-370M: attention-free SSD stack. [arXiv:2405.21060; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    tie_embeddings=True,
)
