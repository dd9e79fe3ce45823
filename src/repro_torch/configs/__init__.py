"""Config registry for the 10 assigned architectures.

A near-verbatim copy of the JAX package's ``configs``: the configs are
data, and the port imports nothing of that package.
"""
from .base import ArchConfig, ShapeCfg, SHAPES

from . import (qwen3_32b, minitron_8b, gemma3_1b, gemma2_9b, dbrx_132b,
               llama4_scout_17b_a16e, mamba2_370m, hubert_xlarge,
               paligemma_3b, zamba2_1_2b)

_MODULES = [qwen3_32b, minitron_8b, gemma3_1b, gemma2_9b, dbrx_132b,
            llama4_scout_17b_a16e, mamba2_370m, hubert_xlarge,
            paligemma_3b, zamba2_1_2b]

REGISTRY = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str, smoke: bool = False, **overrides) -> ArchConfig:
    cfg = REGISTRY[name]
    if smoke:
        cfg = cfg.reduced()
    if overrides:
        import dataclasses
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


# Which (arch x shape) cells are runnable, with skip reasons (DESIGN.md
# §Arch-applicability documents these).
SKIPS = {
    ("hubert-xlarge", "decode_32k"): "encoder-only: no decode step",
    ("hubert-xlarge", "long_500k"): "encoder-only: no decode step",
    ("qwen3-32b", "long_500k"): "pure full attention: O(S) KV infeasible",
    ("minitron-8b", "long_500k"): "pure full attention: O(S) KV infeasible",
    ("gemma2-9b", "long_500k"):
        "1:1 global layers: 21-layer full 500k KV infeasible",
    ("dbrx-132b", "long_500k"): "pure full attention: O(S) KV infeasible",
    ("llama4-scout-17b-a16e", "long_500k"):
        "pure full attention: O(S) KV infeasible",
    ("paligemma-3b", "long_500k"): "pure full attention: O(S) KV infeasible",
}


def cell_runnable(arch: str, shape: str) -> bool:
    return (arch, shape) not in SKIPS
