"""DBRX-132B: 16-expert top-4 fine-grained MoE.
[hf:databricks/dbrx-base; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    n_experts=16, top_k=4, d_ff_expert=10752,
    rope_theta=500_000.0,
)
