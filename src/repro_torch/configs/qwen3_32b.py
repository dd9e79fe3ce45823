"""Qwen3-32B: dense GQA decoder with qk-norm. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab_size=151936,
    qk_norm=True, rope_theta=1_000_000.0,
)
