"""Minitron-8B: width-pruned Nemotron-4 dense. [arXiv:2407.14679; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=256000,
    rope_theta=500_000.0,
)
