"""PaliGemma-3B: SigLIP stub + gemma decoder, prefix-LM.
[arXiv:2407.07726; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216,
    n_vis_tokens=256, d_vis=1152,
    rope_theta=10_000.0, tie_embeddings=True,
)
