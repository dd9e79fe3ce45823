"""Llama4-Scout 17B-active/16E: top-1 MoE + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    n_experts=16, top_k=1, d_ff_expert=8192, n_shared_experts=1,
    rope_theta=500_000.0,
)
