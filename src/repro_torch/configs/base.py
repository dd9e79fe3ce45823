"""Architecture configuration schema shared by all 10 assigned archs."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention variants
    qk_norm: bool = False
    attn_logit_cap: Optional[float] = None
    final_logit_cap: Optional[float] = None
    rope_theta: float = 10_000.0
    rope_theta_global: Optional[float] = None   # gemma3 dual-theta
    # layer pattern: how many local (sliding-window) layers per global
    # layer; None => all layers global full attention.
    local_per_global: Optional[int] = None
    window: int = 4096

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0       # llama4-style always-on expert
    router_aux_coef: float = 0.01

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128

    # hybrid (zamba2): one shared attention block every N ssm layers
    shared_attn_every: int = 0

    # VLM
    n_vis_tokens: int = 0
    d_vis: int = 0

    tie_embeddings: bool = False
    vocab_round_to: int = 256       # pad vocab for shardability
    norm_eps: float = 1e-6
    max_seq: int = 32768

    # execution knobs (overridable per run; part of the perf surface)
    q_chunk: int = 512
    k_chunk: int = 512
    attn_schedule: str = "masked"   # masked | banded  (§Perf knob)
    remat: bool = True
    scan_layers: bool = True
    ce_chunk: int = 512
    # §Perf knobs (hillclimb iterations; defaults = paper-faithful baseline)
    moe_local_dispatch: bool = False   # expert-choice within data shard
    attn_fallback: str = "hd"          # hd | replicate (heads % model != 0)
    kv_cache_dtype: str = "bf16"       # bf16 | int8 (MCIM int8 KV cache)

    @property
    def padded_vocab(self) -> int:
        r = self.vocab_round_to
        return -(-self.vocab_size // r) * r

    @property
    def d_inner(self) -> int:        # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test scale: same family/wiring, tiny dims.

        Layer counts are chosen to exercise every structural path of the
        full config: at least one full pattern group AND a remainder
        tail where the full config has one.
        """
        if self.local_per_global is not None:
            n_layers = (self.local_per_global + 1) + 2   # 1 group + tail
        elif self.shared_attn_every:
            n_layers = 2 * min(self.shared_attn_every, 2) + 1
        else:
            n_layers = min(self.n_layers, 4)
        shrink = dict(
            n_layers=n_layers,
            d_model=128,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            d_ff_expert=128 if self.d_ff_expert else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            n_vis_tokens=16 if self.n_vis_tokens else 0,
            d_vis=64 if self.d_vis else 0,
            window=64,
            max_seq=256,
            q_chunk=64,
            k_chunk=64,
            ce_chunk=64,
            shared_attn_every=min(self.shared_attn_every, 2)
            if self.shared_attn_every else 0,
        )
        if self.n_kv_heads and shrink["n_heads"] % shrink["n_kv_heads"]:
            shrink["n_kv_heads"] = 1
        shrink.update(overrides)
        return dataclasses.replace(self, **shrink)


# Input shape set shared by all LM-family archs (the assignment's 4 shapes)
@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}
