"""Decoder-only transformer: dense, gemma-style local/global, MoE.

The JAX package scans its layer stack over pattern groups (e.g. gemma3's
5 local + 1 global); here the stack is a Python loop over the layers in
the same order (:func:`layer_kinds`).  Templates keep the reference's
shapes and leaf names; caches are one dict a layer, in layer order.  An
MoE layer's MLP is :func:`repro_torch.models.moe.moe_apply`, whose
router z-loss the stack sums as the reference's ``aux`` (serving does
not use it).

Modes:
  train    -- full-sequence forward, chunked CE loss; no cache, one
              matmul call a projection, and where ``cfg.remat`` is set
              each pattern group (and tail layer) recomputed in the
              backward pass, the unit the reference remats
  prefill  -- full-sequence forward, returns KV caches + last logits
  decode   -- one token per call against the caches (ring buffers for
              sliding-window layers), written in place

Decode writes a row's key and value only where its slot lies inside the
cache: a global layer's slot is ``pos`` itself, and a caller that keeps
stepping a finished sequence moves ``pos`` past the cache.  The JAX
package drops those out-of-range scatter updates; so does this module.
"""
from __future__ import annotations

import collections
import math

import torch
from torch.utils.checkpoint import checkpoint

from . import base
from .attention import flash_attention, decode_attention, \
    decode_attention_int8, _quant_rows
from .base import Param
from ..configs.base import ArchConfig

#: shape and dtype of one cache tensor (the reference's ShapeDtypeStruct)
TensorSpec = collections.namedtuple("TensorSpec", "shape dtype")


def group_pattern(cfg: ArchConfig):
    """(k_local, has_global, n_groups, n_tail_local) for the layer stack."""
    if cfg.local_per_global is None:
        return 0, True, cfg.n_layers, 0
    size = cfg.local_per_global + 1
    return (cfg.local_per_global, True, cfg.n_layers // size,
            cfg.n_layers % size)


def layer_kinds(cfg: ArchConfig) -> list:
    """"local" / "global" of every layer, in the order the stack runs:
    each group's locals then its global, then the tail's locals."""
    k_local, has_global, n_groups, n_tail = group_pattern(cfg)
    group = ["local"] * k_local + (["global"] if has_global else [])
    return group * n_groups + ["local"] * n_tail


def layer_theta(cfg: ArchConfig, kind: str) -> float:
    if kind == "global" and cfg.rope_theta_global is not None:
        return cfg.rope_theta_global
    return cfg.rope_theta


# ------------------------------------------------------------------ templates

def attn_template(cfg: ArchConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = {
        "norm": Param((d,), (None,), init="zeros"),
        "wq": Param((d, h * hd), ("fsdp", "model")),
        "wk": Param((d, kv * hd), ("fsdp", "model")),
        "wv": Param((d, kv * hd), ("fsdp", "model")),
        "wo": Param((h * hd, d), ("model", "fsdp"), init="scaled"),
    }
    if cfg.qk_norm:
        t["q_norm"] = Param((hd,), (None,), init="zeros")
        t["k_norm"] = Param((hd,), (None,), init="zeros")
    return t


def mlp_template(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": Param((d,), (None,), init="zeros"),
        "w_gate": Param((d, f), ("fsdp", "model")),
        "w_up": Param((d, f), ("fsdp", "model")),
        "w_down": Param((f, d), ("model", "fsdp"), init="scaled"),
    }


def layer_template(cfg: ArchConfig) -> dict:
    from . import moe
    t = {"attn": attn_template(cfg)}
    if cfg.family == "moe":
        t["moe"] = moe.moe_template(cfg)
    else:
        t["mlp"] = mlp_template(cfg)
    return t


def lm_templates(cfg: ArchConfig) -> dict:
    """The reference's template tree: groups and tail stacked."""
    k_local, has_global, n_groups, n_tail = group_pattern(cfg)
    group = {}
    if k_local:
        group["local"] = base.stack(layer_template(cfg), k_local)
    if has_global:
        group["global"] = layer_template(cfg)
    tpl = {
        "embed": Param((cfg.padded_vocab, cfg.d_model), ("model", "fsdp")),
        "final_norm": Param((cfg.d_model,), (None,), init="zeros"),
        "groups": base.stack(group, n_groups, "layers"),
    }
    if n_tail:
        tpl["tail"] = base.stack(layer_template(cfg), n_tail, "layers")
    if not cfg.tie_embeddings:
        tpl["unembed"] = Param((cfg.d_model, cfg.padded_vocab),
                               ("fsdp", "model"))
    return tpl


# ------------------------------------------------------------------ caches

def attn_cache_spec(cfg: ArchConfig, batch: int, s_cap: int, kind: str):
    cap = min(cfg.window, s_cap) if kind == "local" else s_cap
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    shp = (batch, cap, kv, hd)
    if cfg.kv_cache_dtype == "int8":
        # MCIM int8 KV cache: halves the dominant decode HBM traffic;
        # per-(pos, head) f32 scales.
        return {"k": TensorSpec(shp, torch.int8),
                "v": TensorSpec(shp, torch.int8),
                "k_scale": TensorSpec(shp[:3], torch.float32),
                "v_scale": TensorSpec(shp[:3], torch.float32)}
    return {"k": TensorSpec(shp, torch.bfloat16),
            "v": TensorSpec(shp, torch.bfloat16)}


def lm_cache_spec(cfg: ArchConfig, batch: int, s_cap: int) -> list:
    """One ``{name: TensorSpec}`` a layer, in layer order."""
    return [attn_cache_spec(cfg, batch, s_cap, kind)
            for kind in layer_kinds(cfg)]


def init_cache(spec: list, device) -> list:
    """Zeroed caches of a :func:`lm_cache_spec` on ``device``."""
    return [{name: torch.zeros(s.shape, dtype=s.dtype, device=device)
             for name, s in layer.items()} for layer in spec]


def _quant_kv(x):
    """Symmetric int8 over head_dim. x: (..., hd) -> (int8, f32 scale)."""
    q, scale = _quant_rows(x.to(torch.float32))
    return q, scale[..., 0]


# ------------------------------------------------------------------ layers

def _decode_write(cache, kind, pos, k, v, int8: bool):
    """Write this step's key/value rows at their slots, in place; rows
    whose slot lies past the cache are dropped.  Returns ``valid``."""
    cap = cache["k"].shape[1]
    ar = torch.arange(cap, device=pos.device)
    if kind == "local":
        slot = pos % cap
        valid = ar[None, :] < torch.clamp(pos + 1, max=cap)[:, None]
    else:
        slot = pos
        valid = ar[None, :] <= pos[:, None]
    # an out-of-range row rewrites the value it finds at the last slot,
    # so the write needs no host sync to pick its rows
    inside = slot < cap
    slot = torch.clamp(slot, max=cap - 1)
    rows = torch.arange(pos.shape[0], device=pos.device)
    if int8:
        qk, sk = _quant_kv(k[:, 0])
        qv, sv = _quant_kv(v[:, 0])
        new = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    else:
        new = {"k": k[:, 0], "v": v[:, 0]}
    for name, val in new.items():
        buf = cache[name]
        keep = inside.view((-1,) + (1,) * (val.dim() - 1))
        buf[rows, slot] = torch.where(keep, val, buf[rows, slot])
    return valid


def _prefill_write(cache, kind, k, v, int8: bool):
    """Write the prompt's keys/values into a fresh cache, in place: the
    first ``s`` slots, or for a ring shorter than the prompt its last
    ``cap`` positions at ``position % cap``."""
    s = k.shape[1]
    cap = cache["k"].shape[1]
    if int8:
        k_store, ks = _quant_kv(k)
        v_store, vs = _quant_kv(v)
        new = {"k": k_store, "v": v_store, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k, "v": v}
    if kind == "local" and s >= cap:
        slots = torch.arange(s - cap, s, device=k.device) % cap
        for name, val in new.items():
            cache[name][:, slots] = val[:, s - cap:]
    else:
        for name, val in new.items():
            cache[name][:, :s] = val


def attn_apply(p, x, cfg: ArchConfig, kind: str, mode: str,
               positions=None, pos=None, cache=None, prefix_len=None,
               mask_override=None):
    """Returns ``x + attention(x)``; fills ``cache`` in place (keys are
    roped before caching).  A global layer takes the prefix-LM mask when
    ``prefix_len`` is set; ``mask_override`` replaces the mask kind."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    theta = layer_theta(cfg, kind)
    int8 = cfg.kv_cache_dtype == "int8"
    train = mode == "train"
    xn = base.rms_norm(x, p.norm, cfg.norm_eps)
    q = base.matmul(xn, p.wq, train).reshape(b, s, h, hd)
    k = base.matmul(xn, p.wk, train).reshape(b, s, kv, hd)
    v = base.matmul(xn, p.wv, train).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = base.rms_norm(q, p.q_norm, cfg.norm_eps)
        k = base.rms_norm(k, p.k_norm, cfg.norm_eps)

    if mode == "decode":
        q = base.rope(q, pos[:, None].to(torch.float32), theta)
        k = base.rope(k, pos[:, None].to(torch.float32), theta)
        valid = _decode_write(cache, kind, pos, k, v, int8)
        if int8:
            # integer-domain attention: int8 reads end to end, scales
            # deferred to the end (PPM -> compressor -> final adder).
            o = decode_attention_int8(
                q, cache["k"], cache["k_scale"], cache["v"],
                cache["v_scale"], valid, logit_cap=cfg.attn_logit_cap)
        else:
            o = decode_attention(q, cache["k"], cache["v"], valid,
                                 logit_cap=cfg.attn_logit_cap)
    else:
        q = base.rope(q, positions.to(torch.float32), theta)
        k = base.rope(k, positions.to(torch.float32), theta)
        mask_kind = ("local" if kind == "local"
                     else ("prefix" if prefix_len is not None else "causal"))
        if mask_override is not None:
            mask_kind = mask_override
        o = flash_attention(
            q, k, v, mask_kind=mask_kind, window=cfg.window,
            prefix_len=prefix_len, logit_cap=cfg.attn_logit_cap,
            q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
            schedule=cfg.attn_schedule)
        if cache is not None:
            _prefill_write(cache, kind, k, v, int8)
    return x + base.matmul(o.reshape(b, s, h * hd), p.wo, train)


def mlp_apply(p, x, cfg: ArchConfig, train: bool = False):
    xn = base.rms_norm(x, p.norm, cfg.norm_eps)
    return x + base.swiglu(xn, p.w_gate, p.w_up, p.w_down, train)


def layer_apply(layer, x, cfg: ArchConfig, mode: str, **kw):
    """Returns (x, aux): aux is an MoE layer's router z-loss, else 0."""
    from . import moe
    x = attn_apply(layer.attn, x, cfg, layer.kind, mode, **kw)
    if cfg.family == "moe":
        return moe.moe_apply(layer.moe, x, cfg, decode=(mode == "decode"),
                             train=(mode == "train"))
    return mlp_apply(layer.mlp, x, cfg, mode == "train"), 0.0


def remat_units(cfg: ArchConfig) -> list:
    """Layer counts of the units the reference remats in train mode, in
    stack order: each pattern group, then each tail layer."""
    k_local, has_global, n_groups, n_tail = group_pattern(cfg)
    return [k_local + has_global] * n_groups + [1] * n_tail


def run_units(fn, units: list, x, remat: bool):
    """``x, aux = fn(i, x)`` over layers 0.. in units of ``units``
    layers; with ``remat`` each unit is a ``checkpoint``, recomputed in
    the backward pass (the same values: recomputing changes no bit).
    Returns (x, summed aux)."""
    def unit(x, first, n):
        aux = 0.0
        for i in range(first, first + n):
            x, a = fn(i, x)
            aux = aux + a
        return x, aux

    aux, first = 0.0, 0
    for n in units:
        if remat:
            x, a = checkpoint(unit, x, first, n, use_reentrant=False)
        else:
            x, a = unit(x, first, n)
        aux, first = aux + a, first + n
    return x, aux


def stack_apply(layers, x, cfg: ArchConfig, mode: str, caches=None, **kw):
    """Run the layer stack in order; fills ``caches`` in place.  Returns
    (x, summed aux)."""
    def one(i, x):
        return layer_apply(layers[i], x, cfg, mode,
                           cache=None if caches is None else caches[i], **kw)
    return run_units(one, remat_units(cfg), x,
                     mode == "train" and cfg.remat)


# ------------------------------------------------------------------ LM API

def embed_tokens(model, tokens, cfg: ArchConfig, scale: bool):
    x = model.embed[tokens]
    if scale:    # sqrt(d_model) in float32, rounded to the working dtype
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=torch.float32,
                           device=x.device).to(x.dtype)
    return x


def unembed_matrix(model, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return model.embed.T
    return model.unembed


def loss_mask(batch) -> torch.Tensor:
    """``batch["mask"]``, or float32 ones shaped as the labels."""
    mask = batch.get("mask")
    if mask is None:
        labels = batch["labels"]
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    return mask


def lm_train_loss(model, batch, cfg: ArchConfig, embed_scale: bool = False):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``
    (B, S), optional float ``mask``); an MoE adds
    ``router_aux_coef * aux / n_layers``."""
    tokens, labels = batch["tokens"], batch["labels"]
    mask = loss_mask(batch)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed_tokens(model, tokens, cfg, embed_scale)
    x, aux = stack_apply(model.layers, x, cfg, "train", positions=positions)
    x = base.rms_norm(x, model.final_norm, cfg.norm_eps)
    w = unembed_matrix(model, cfg)
    ce = base.cross_entropy_chunked(
        lambda xs: base.matmul(xs, w, train=True), x, labels, mask,
        chunk=cfg.ce_chunk, final_cap=cfg.final_logit_cap)
    if cfg.family == "moe":
        ce = ce + cfg.router_aux_coef * aux / cfg.n_layers
    return ce


def lm_prefill(model, tokens, cfg: ArchConfig, s_cap=None,
               embed_scale: bool = False, prefix_len=None):
    """Returns (caches, last_token_logits)."""
    b, s = tokens.shape
    s_cap = s_cap or cfg.max_seq
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    caches = init_cache(lm_cache_spec(cfg, b, s_cap), tokens.device)
    x = embed_tokens(model, tokens, cfg, embed_scale)
    x, _ = stack_apply(model.layers, x, cfg, "prefill", caches=caches,
                       positions=positions, prefix_len=prefix_len)
    x = base.rms_norm(x[:, -1:], model.final_norm, cfg.norm_eps)
    logits = base.softcap(base.matmul(x, unembed_matrix(model, cfg)),
                          cfg.final_logit_cap)
    return caches, logits[:, 0]


def lm_decode_step(model, caches, token, pos, cfg: ArchConfig,
                   embed_scale: bool = False):
    """token: (B,) int, pos: (B,) int.  Returns (caches, logits (B, V));
    ``caches`` is updated in place and returned."""
    x = embed_tokens(model, token[:, None], cfg, embed_scale)
    x, _ = stack_apply(model.layers, x, cfg, "decode", caches=caches,
                       pos=pos)
    x = base.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = base.softcap(base.matmul(x, unembed_matrix(model, cfg)),
                          cfg.final_logit_cap)
    return caches, logits[:, 0]
