"""HuBERT-style encoder-only backbone, as the JAX package's
``models/encoder.py``.

The conv/audio frontend is a stub: the input is precomputed frame
embeddings (B, T, ``D_FRONTEND``), lifted to d_model by a learned
projection.  The backbone is a bidirectional transformer (mask kind
"none").  Encoder-only: no KV cache and no decode step.  The loss
(:func:`encoder_train_loss`) is cross-entropy on the masked frames
only; in train mode each layer is the unit ``cfg.remat`` recomputes.
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


def _encode(model, frames, mask, cfg: ArchConfig, mode: str, mesh=None):
    """frames (B, T, D_FRONTEND); ``mask`` (B, T) bool or None: frames
    replaced by ``mask_embed``.  Returns the final-normed (B, T, D)."""
    b, s, _ = frames.shape
    train = mode == "train"
    # bf16 frames, promoted to a float32 projection's dtype as jnp does
    x = base.matmul(frames.to(torch.bfloat16).to(model.frame_proj.dtype),
                    model.frame_proj, train)
    if mask is not None:
        x = torch.where(mask[..., None], model.mask_embed, x)
    x = base.constrain(x, mesh, "batch", None, None)
    positions = torch.arange(s, device=frames.device).expand(b, s)

    def one(i, x):
        return tfm.layer_apply(model.layers[i], x, cfg, mode, mesh=mesh,
                               positions=positions, mask_override="none")
    x, _ = tfm.run_units(one, [1] * cfg.n_layers, x, train and cfg.remat)
    return base.rms_norm(x, model.final_norm, cfg.norm_eps)


def encoder_train_loss(model, batch, cfg: ArchConfig, mesh=None):
    """batch: frames (B, T, 512) bf16, mask (B, T) bool, labels (B, T)
    ints; cross-entropy on the masked frames only."""
    frames, mask, labels = batch["frames"], batch["mask"], batch["labels"]
    x = _encode(model, frames, mask, cfg, "train", mesh)
    return base.cross_entropy_chunked(
        lambda xs: base.matmul(xs, model.lm_head, train=True), x, labels,
        mask.to(torch.float32), chunk=cfg.ce_chunk, mesh=mesh)


def encoder_forward(model, frames, cfg: ArchConfig, mesh=None):
    """Serving path: full-sequence unit logits (B, T, V); on a ``mesh``
    (DTensor ``frames``) batch over the data axes, whole vocabulary."""
    logits = base.matmul(_encode(model, frames, None, cfg, "prefill", mesh),
                         model.lm_head)
    return base.constrain(logits, mesh, "batch", None, None)
