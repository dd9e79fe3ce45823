"""SSM and hybrid LMs: mamba2 (pure SSD stack) and zamba2 (Mamba2 +
shared attention blocks), as the JAX package's ``models/hybrid.py``.

zamba2 re-uses ONE transformer block (attention + MLP) every
``shared_attn_every`` Mamba layers; each *application* still has its own
KV cache.  mamba2 is the ``shared_attn_every == 0`` case (no attention).

The model holds the Mamba layers in the order the stack runs (each
group's ``every`` layers, then the tail's) and the one ``shared_attn``
block.  Caches are one batch-first dict per application, in the same
order: each group's shared-attention cache, then its Mamba caches, then
the tail's.  No embedding scale and no final softcap, as the reference.
In train mode (no caches) each group, and each tail layer, is the unit
``cfg.remat`` recomputes in the backward pass, as the reference's.
"""
from __future__ import annotations

import itertools

import torch

from . import base
from . import transformer as tfm
from .base import Param
from .ssm import ssm_apply, ssm_cache_spec, ssm_template
from ..configs.base import ArchConfig


def pattern(cfg: ArchConfig):
    """(every, n_groups, n_tail) of the Mamba stack."""
    every = cfg.shared_attn_every
    if every:
        return every, cfg.n_layers // every, cfg.n_layers % every
    return 1, cfg.n_layers, 0


def hybrid_templates(cfg: ArchConfig) -> dict:
    """The reference's template tree: groups and tail stacked."""
    every, n_groups, n_tail = pattern(cfg)
    group = {"mamba": base.stack(ssm_template(cfg), every)}
    tpl = {
        "embed": Param((cfg.padded_vocab, cfg.d_model), ("model", "fsdp")),
        "final_norm": Param((cfg.d_model,), (None,), init="zeros"),
        "groups": base.stack(group, n_groups, "layers"),
    }
    if n_tail:
        tpl["tail"] = base.stack(ssm_template(cfg), n_tail, "layers")
    if cfg.shared_attn_every:
        tpl["shared_attn"] = tfm.layer_template(cfg)   # ONE copy, reused
    if not cfg.tie_embeddings:
        tpl["unembed"] = Param((cfg.d_model, cfg.padded_vocab),
                               ("fsdp", "model"))
    return tpl


def hybrid_cache_spec(cfg: ArchConfig, batch: int, s_cap: int) -> list:
    """One ``{name: TensorSpec}`` per application, in the order the stack
    runs."""
    every, n_groups, n_tail = pattern(cfg)
    group = [ssm_cache_spec(cfg, batch)] * every
    if cfg.shared_attn_every:
        group = [tfm.attn_cache_spec(cfg, batch, s_cap, "global")] + group
    return group * n_groups + [ssm_cache_spec(cfg, batch)] * n_tail


def stack_apply(model, x, cfg: ArchConfig, mode: str, caches=None,
                positions=None, pos=None, mesh=None):
    """Each group's shared block, then its Mamba layers; then the tail.
    Fills ``caches`` in place."""
    every, n_groups, n_tail = pattern(cfg)
    apps = iter(caches) if caches is not None else itertools.repeat(None)

    def one(i, x):
        """Mamba layer ``i``, after the shared block where a group
        starts."""
        if cfg.shared_attn_every and i < n_groups * every \
                and i % every == 0:
            x, _ = tfm.layer_apply(model.shared_attn, x, cfg, mode,
                                   cache=next(apps), mesh=mesh,
                                   positions=positions, pos=pos)
        return ssm_apply(model.layers[i], x, cfg, mode,
                         cache=next(apps), mesh=mesh), 0.0

    return tfm.run_units(one, [every] * n_groups + [1] * n_tail, x,
                         mode == "train" and cfg.remat)[0]


def lm_train_loss(model, batch, cfg: ArchConfig, mesh=None):
    """Mean next-token cross-entropy of ``batch`` (``tokens``,
    ``labels``, optional ``mask``)."""
    tokens, labels = batch["tokens"], batch["labels"]
    mask = tfm.loss_mask(batch)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = tfm.embed_tokens(model, tokens, cfg, False, mesh)
    x = stack_apply(model, x, cfg, "train", positions=positions, mesh=mesh)
    x = base.rms_norm(x, model.final_norm, cfg.norm_eps)
    w = tfm.unembed_matrix(model, cfg)
    return base.cross_entropy_chunked(
        lambda xs: base.matmul(xs, w, train=True), x, labels, mask,
        chunk=cfg.ce_chunk, final_cap=cfg.final_logit_cap, mesh=mesh)


def lm_prefill(model, tokens, cfg: ArchConfig, s_cap=None, mesh=None):
    """Returns (caches, last_token_logits); on a ``mesh`` (DTensor
    ``tokens``) DTensor caches at ``cache_specs``' placements."""
    b, s = tokens.shape
    s_cap = s_cap or cfg.max_seq
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    caches = tfm.init_cache(hybrid_cache_spec(cfg, b, s_cap), tokens.device,
                            mesh)
    x = tfm.embed_tokens(model, tokens, cfg, False, mesh)
    x = stack_apply(model, x, cfg, "prefill", caches=caches,
                    positions=positions, mesh=mesh)
    return caches, tfm.last_logits(model, x, cfg, mesh)


def lm_decode_step(model, caches, token, pos, cfg: ArchConfig, mesh=None):
    """token, pos: (B,) ints.  Returns (caches, logits (B, V)); the
    caches are updated in place."""
    x = tfm.embed_tokens(model, token[:, None], cfg, False, mesh)
    x = stack_apply(model, x, cfg, "decode", caches=caches, pos=pos,
                    mesh=mesh)
    return caches, tfm.last_logits(model, x, cfg, mesh)
