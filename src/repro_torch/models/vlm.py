"""PaliGemma-style VLM: SigLIP vision stub + gemma-family decoder, as the
JAX package's ``models/vlm.py``.

The vision tower is a stub: the input is precomputed patch embeddings
(B, n_vis_tokens, d_vis), lifted into the LM's embedding space by a
learned linear projector.  The sequence is [image tokens | text tokens]
under a prefix-LM mask (the image prefix attends bidirectionally, text
is causal); text embeddings take the gemma scale.  The loss
(:func:`vlm_train_loss`) scores text positions only.
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


def _embed_multimodal(model, image_embeds, tokens, cfg: ArchConfig,
                      train: bool = False, mesh=None):
    # bf16 patches, promoted to a float32 projector's dtype as jnp does
    vis = base.matmul(image_embeds.to(torch.bfloat16).to(
        model.vis_proj.dtype), model.vis_proj, train)
    txt = tfm.embed_tokens(model, tokens, cfg, scale=True, mesh=mesh)
    x = torch.cat([vis.to(txt.dtype), txt], dim=1)
    return base.constrain(x, mesh, "batch", None, None)


def _zeros_before(t, n: int, dtype):
    """(B, n) zeros of ``dtype`` laid out as ``t`` (B, ...)."""
    if isinstance(t, base.DTensor):
        local = t.to_local()
        return base.DTensor.from_local(
            torch.zeros((local.shape[0], n), dtype=dtype,
                        device=local.device), t.device_mesh, t.placements,
            run_check=False)
    return torch.zeros((t.shape[0], n), dtype=dtype, device=t.device)


def vlm_train_loss(model, batch, cfg: ArchConfig, mesh=None):
    """batch: image_embeds (B, n_vis_tokens, d_vis), tokens and labels
    (B, St), optional mask; the image positions are never scored."""
    img, tokens, labels = (batch["image_embeds"], batch["tokens"],
                           batch["labels"])
    mask = tfm.loss_mask(batch)
    b, st = tokens.shape
    nv = cfg.n_vis_tokens
    x = _embed_multimodal(model, img, tokens, cfg, train=True, mesh=mesh)
    s = nv + st
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x, _ = tfm.stack_apply(model.layers, x, cfg, "train",
                           positions=positions, prefix_len=nv, mesh=mesh)
    x = base.rms_norm(x, model.final_norm, cfg.norm_eps)
    full_labels = torch.cat([_zeros_before(labels, nv, labels.dtype),
                             labels], 1)
    full_mask = torch.cat([_zeros_before(labels, nv, torch.float32),
                           mask.to(torch.float32)], 1)
    w = tfm.unembed_matrix(model, cfg)
    return base.cross_entropy_chunked(
        lambda xs: base.matmul(xs, w, train=True), x, full_labels,
        full_mask, chunk=cfg.ce_chunk, final_cap=cfg.final_logit_cap,
        mesh=mesh)


def vlm_prefill(model, image_embeds, tokens, cfg: ArchConfig, s_cap=None,
                mesh=None):
    """image_embeds (B, n_vis_tokens, d_vis), tokens (B, St) -> (caches,
    last_token_logits); on a ``mesh`` both are DTensors."""
    b, st = tokens.shape
    nv = cfg.n_vis_tokens
    s = nv + st
    s_cap = s_cap or cfg.max_seq
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    caches = tfm.init_cache(tfm.lm_cache_spec(cfg, b, s_cap), tokens.device,
                            mesh)
    x = _embed_multimodal(model, image_embeds, tokens, cfg, mesh=mesh)
    x, _ = tfm.stack_apply(model.layers, x, cfg, "prefill", caches=caches,
                           positions=positions, prefix_len=nv, mesh=mesh)
    return caches, tfm.last_logits(model, x, cfg, mesh)


def vlm_decode_step(model, caches, token, pos, cfg: ArchConfig, mesh=None):
    return tfm.lm_decode_step(model, caches, token, pos, cfg,
                              embed_scale=True, mesh=mesh)
