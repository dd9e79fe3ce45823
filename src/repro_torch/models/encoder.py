"""HuBERT-style encoder-only backbone, as the JAX package's
``models/encoder.py``.

The conv/audio frontend is a stub: the input is precomputed frame
embeddings (B, T, ``D_FRONTEND``), lifted to d_model by a learned
projection.  The backbone is a bidirectional transformer (mask kind
"none").  Encoder-only: no KV cache and no decode step.  The
masked-prediction loss (``encoder_train_loss``) waits for the training
stack (ROADMAP queue 1).
"""
from __future__ import annotations

import torch

from . import base
from . import transformer as tfm
from .base import Param
from ..configs.base import ArchConfig

D_FRONTEND = 512          # conv-frontend output width (w2v2/HuBERT standard)


def encoder_templates(cfg: ArchConfig) -> dict:
    """The reference's template tree: layers stacked."""
    return {
        "frame_proj": Param((D_FRONTEND, cfg.d_model), (None, "fsdp")),
        "mask_embed": Param((cfg.d_model,), (None,)),
        "layers": base.stack(tfm.layer_template(cfg), cfg.n_layers,
                             "layers"),
        "final_norm": Param((cfg.d_model,), (None,), init="zeros"),
        "lm_head": Param((cfg.d_model, cfg.padded_vocab), ("fsdp", "model")),
    }


def _encode(model, frames, mask, cfg: ArchConfig):
    """frames (B, T, D_FRONTEND); ``mask`` (B, T) bool or None: frames
    replaced by ``mask_embed``.  Returns the final-normed (B, T, D)."""
    b, s, _ = frames.shape
    x = base.matmul(frames.to(torch.bfloat16), model.frame_proj)
    if mask is not None:
        x = torch.where(mask[..., None], model.mask_embed, x)
    positions = torch.arange(s, device=frames.device).expand(b, s)
    for layer in model.layers:
        x, _ = tfm.layer_apply(layer, x, cfg, "prefill", positions=positions,
                               mask_override="none")
    return base.rms_norm(x, model.final_norm, cfg.norm_eps)


def encoder_forward(model, frames, cfg: ArchConfig):
    """Serving path: full-sequence unit logits (B, T, V)."""
    return base.matmul(_encode(model, frames, None, cfg), model.lm_head)
