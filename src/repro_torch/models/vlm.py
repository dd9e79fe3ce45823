"""PaliGemma-style VLM: SigLIP vision stub + gemma-family decoder, as the
JAX package's ``models/vlm.py``.

The vision tower is a stub: the input is precomputed patch embeddings
(B, n_vis_tokens, d_vis), lifted into the LM's embedding space by a
learned linear projector.  The sequence is [image tokens | text tokens]
under a prefix-LM mask (the image prefix attends bidirectionally, text
is causal); text embeddings take the gemma scale.  The text-only loss
(``vlm_train_loss``) waits for the training stack (ROADMAP queue 1).
"""
from __future__ import annotations

import torch

from . import base
from . import transformer as tfm
from .base import Param
from ..configs.base import ArchConfig


def vlm_templates(cfg: ArchConfig) -> dict:
    tpl = tfm.lm_templates(cfg)
    tpl["vis_proj"] = Param((cfg.d_vis, cfg.d_model), (None, "fsdp"))
    return tpl


def _embed_multimodal(model, image_embeds, tokens, cfg: ArchConfig):
    vis = base.matmul(image_embeds.to(torch.bfloat16), model.vis_proj)
    txt = tfm.embed_tokens(model, tokens, cfg, scale=True)
    return torch.cat([vis.to(txt.dtype), txt], dim=1)


def vlm_prefill(model, image_embeds, tokens, cfg: ArchConfig, s_cap=None):
    """image_embeds (B, n_vis_tokens, d_vis), tokens (B, St) -> (caches,
    last_token_logits)."""
    b, st = tokens.shape
    nv = cfg.n_vis_tokens
    s = nv + st
    s_cap = s_cap or cfg.max_seq
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    caches = tfm.init_cache(tfm.lm_cache_spec(cfg, b, s_cap), tokens.device)
    x = _embed_multimodal(model, image_embeds, tokens, cfg)
    x, _ = tfm.stack_apply(model.layers, x, cfg, "prefill", caches=caches,
                           positions=positions, prefix_len=nv)
    x = base.rms_norm(x[:, -1:], model.final_norm, cfg.norm_eps)
    logits = base.softcap(base.matmul(x, tfm.unembed_matrix(model, cfg)),
                          cfg.final_logit_cap)
    return caches, logits[:, 0]


def vlm_decode_step(model, caches, token, pos, cfg: ArchConfig):
    return tfm.lm_decode_step(model, caches, token, pos, cfg,
                              embed_scale=True)
