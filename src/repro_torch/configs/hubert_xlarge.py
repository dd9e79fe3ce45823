"""HuBERT-XLarge: encoder-only audio backbone (frontend stubbed).
[arXiv:2106.07447; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
)
