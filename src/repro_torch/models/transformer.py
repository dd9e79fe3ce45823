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

Every mode also runs on a ``mesh`` (DTensor activations, batch-sharded
over the data axes): the reference's ``constrain_act``,
``constrain_heads`` and ``constrain_kv`` become ``redistribute`` calls
at its points, with its ``attn_fallback`` rules, and the attention runs
on each rank's heads (:func:`attention_layout`), or its sequence slice
(``flash_attention_context_parallel``, the reference's selection rule).
Serving on a mesh keeps DTensor caches at ``launch.sharding``'s
``cache_specs`` placements (:func:`cache_layout`): a prefill writes each
rank's rows, kv heads, head_dim columns or sequence stretch, and a
decode step reads them there (partial scores over "model" on a split
head_dim; a log-sum-exp over "data" on a split sequence).

Decode writes a row's key and value only where its slot lies inside the
cache: a global layer's slot is ``pos`` itself, and a caller that keeps
stepping a finished sequence moves ``pos`` past the cache.  The JAX
package drops those out-of-range scatter updates; so does this module.
"""
from __future__ import annotations

import collections
import math

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.utils.checkpoint import checkpoint

from . import base
from .attention import flash_attention, decode_attention, \
    decode_attention_int8, _quant_rows, flash_attention_context_parallel
from .base import Param, constrain
from ..configs.base import ArchConfig

#: shape and dtype of one cache tensor (the reference's ShapeDtypeStruct)
TensorSpec = collections.namedtuple("TensorSpec", "shape dtype")


# ------------------------------------------------------------------ mesh

def constrain_act(x, mesh):
    return constrain(x, mesh, "batch", *([None] * (x.ndim - 1)))


def constrain_heads(x, mesh, fallback: str = "hd"):
    """(B, S, H, hd): shard heads on model if divisible; else fall back
    to head_dim ("hd") or replication ("replicate")."""
    if mesh is None:
        return x
    m = base.axis_size(mesh, "model")
    if x.shape[-2] % m == 0:
        return constrain(x, mesh, "batch", None, "model", None)
    if fallback == "hd" and x.shape[-1] % m == 0:
        return constrain(x, mesh, "batch", None, None, "model")
    return constrain_act(x, mesh)


def constrain_kv(x, mesh, fallback: str = "hd"):
    """(B, S, KV, hd): kv heads on model when divisible; when they are
    not, "hd" leaves the layout as it comes and "replicate"/"seq"
    replicate over the model axis."""
    if mesh is None:
        return x
    m = base.axis_size(mesh, "model")
    if x.shape[-2] % m == 0:
        return constrain(x, mesh, "batch", None, "model", None)
    if fallback in ("replicate", "seq"):
        return constrain_act(x, mesh)
    return x


def use_context_parallel(cfg: ArchConfig, mesh, s: int) -> bool:
    """The reference's rule: the "seq" fallback, on a model axis the
    sequence divides and the heads do not."""
    m = base.axis_size(mesh, "model")
    return (cfg.attn_fallback == "seq" and mesh is not None
            and "model" in base.mesh_names(mesh)
            and s % max(m, 1) == 0 and cfg.n_heads % m != 0)


def attention_layout(cfg: ArchConfig, mesh):
    """(q's, k's and v's model-axis placement, kv heads a rank takes)
    for the attention on ``mesh``: q on its heads when they divide and
    each rank's heads share whole kv heads (k and v then on their heads,
    or replicated with each rank taking its ``kv_take`` heads); else
    everything replicated over the model axis."""
    m = base.axis_size(mesh, "model")
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if m == 1 or h % m:
        return Replicate(), Replicate(), None
    if kv % m == 0:
        return Shard(2), Shard(2), None
    if (h // kv) % (h // m) == 0:
        return Shard(2), Replicate(), 1
    return Replicate(), Replicate(), None


def _rope_local(mesh, theta, t):
    """``rope`` of a (B, S, n, hd) DTensor, each rank its own rows (the
    positions 0..S-1 of every sequence)."""
    def fn(local):
        b, s = local.shape[:2]
        pos = torch.arange(s, device=local.device).expand(b, s)
        return base.rope(local, pos.to(torch.float32), theta)
    return base.local_map(fn, mesh, (t,), t.placements)


def _attention_mesh(q, k, v, cfg: ArchConfig, mesh, mask_kind, prefix_len):
    """The attention of DTensor q, k, v at :func:`attention_layout`:
    each rank its batch rows and its heads (or all heads)."""
    q_pl, kv_pl, kv_take = attention_layout(cfg, mesh)
    h, kv = cfg.n_heads, cfg.n_kv_heads
    first = None
    if kv_take:   # this rank's q heads all read one kv head
        first = mesh.get_local_rank("model") * (h // base.axis_size(
            mesh, "model")) // (h // kv)

    def fn(ql, kl, vl):
        if first is not None:
            kl, vl = kl[:, :, first:first + 1], vl[:, :, first:first + 1]
        return flash_attention(
            ql, kl, vl, mask_kind=mask_kind, window=cfg.window,
            prefix_len=prefix_len, logit_cap=cfg.attn_logit_cap,
            q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
            schedule=cfg.attn_schedule)
    return base.local_map(fn, mesh, (q, k, v), q.placements)


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


def init_cache(spec: list, device, mesh=None) -> list:
    """Zeroed caches of a :func:`lm_cache_spec` on ``device``; on a
    ``mesh`` DTensors at ``launch.sharding.cache_specs``' placements."""
    if mesh is None:
        return [{name: torch.zeros(s.shape, dtype=s.dtype, device=device)
                 for name, s in layer.items()} for layer in spec]
    from torch.distributed.tensor import zeros
    from ..launch.sharding import cache_specs
    specs = cache_specs(spec, mesh)
    return [{name: zeros(s.shape, dtype=s.dtype, device_mesh=mesh,
                         placements=base.placements(specs[i][name], mesh))
             for name, s in layer.items()} for i, layer in enumerate(spec)]


def cache_layout(cache, mesh):
    """How a layer's DTensor KV cache is split, from its ``k``'s
    placements: (the model-axis placement q, k and v take: ``Shard(2)``
    with kv heads split, else ``Replicate()``; the head_dim columns this
    rank holds, or ``None``; (first slot, capacity, group) of a sequence
    split over the data axis, or ``None``)."""
    k = cache["k"]
    names = base.mesh_names(mesh)
    heads_pl, cols, seq = Replicate(), None, None
    for i, pl in enumerate(k.placements):
        if pl.is_shard(2):
            heads_pl = Shard(2)
        elif pl.is_shard(3):
            cols = base.shard_slice(k, 3)
        elif pl.is_shard(1):
            seq = (base.shard_slice(k, 1).start, k.shape[1],
                   mesh.get_group(names[i]))
    return heads_pl, cols, seq


def _quant_kv(x):
    """Symmetric int8 over head_dim. x: (..., hd) -> (int8, f32 scale)."""
    q, scale = _quant_rows(x.to(torch.float32))
    return q, scale[..., 0]


# ------------------------------------------------------------------ layers

def _new_entries(k, v, int8: bool, cols) -> dict:
    """The cache entries of keys and values (..., KV, hd): int8 with
    scales over the whole head_dim, then the ``cols`` a cache holds."""
    if int8:
        (qk, sk), (qv, sv) = _quant_kv(k), _quant_kv(v)
        new = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    else:
        new = {"k": k, "v": v}
    if cols is not None:
        new["k"], new["v"] = new["k"][..., cols], new["v"][..., cols]
    return new


def _decode_write(cache, kind, pos, k, v, int8: bool, s0: int = 0,
                  cap: int | None = None, cols=None):
    """Write this step's key/value rows at their slots, in place; rows
    whose slot lies past the cache are dropped.  Returns ``valid``.
    A cache holding slots ``s0..`` of a ``cap``-slot sequence (a mesh's
    sequence shard) writes and validates its own slots only."""
    held = cache["k"].shape[1]
    cap = cap or held
    ar = s0 + torch.arange(held, device=pos.device)
    if kind == "local":
        slot = pos % cap
        valid = ar[None, :] < torch.clamp(pos + 1, max=cap)[:, None]
    else:
        slot = pos
        valid = ar[None, :] <= pos[:, None]
    # an out-of-range row rewrites the value it finds at a held slot, so
    # the write needs no host sync to pick its rows
    inside = (slot >= s0) & (slot < s0 + held) & (slot < cap)
    slot = torch.clamp(slot - s0, min=0, max=held - 1)
    rows = torch.arange(pos.shape[0], device=pos.device)
    new = _new_entries(k[:, 0], v[:, 0], int8, cols)
    for name, val in new.items():
        buf = cache[name]
        keep = inside.view((-1,) + (1,) * (val.dim() - 1))
        buf[rows, slot] = torch.where(keep, val.to(buf.dtype),
                                      buf[rows, slot])
    return valid


def _prefill_write(cache, kind, k, v, int8: bool, s0: int = 0,
                   cap: int | None = None, cols=None):
    """Write the prompt's keys/values into a fresh cache, in place: the
    first ``s`` slots, or for a ring shorter than the prompt its last
    ``cap`` positions at ``position % cap``.  A cache holding slots
    ``s0..`` of a ``cap``-slot sequence writes its own slots only."""
    s = k.shape[1]
    held = cache["k"].shape[1]
    cap = cap or held
    new = _new_entries(k, v, int8, cols)
    if kind == "local" and s >= cap:
        # slot j holds the one position of the last cap that is j mod cap
        j = torch.arange(s0, s0 + held, device=k.device)
        src = (s - cap) + (j - (s - cap)) % cap
        for name, val in new.items():
            cache[name].copy_(val[:, src])
    else:
        hi = min(s, s0 + held)
        for name, val in new.items():
            if hi > s0:
                cache[name][:, :hi - s0] = val[:, s0:hi]


def _mask_kind(kind, prefix_len, mask_override):
    if mask_override is not None:
        return mask_override
    return ("local" if kind == "local"
            else ("prefix" if prefix_len is not None else "causal"))


def _attn_mesh(p, x, xn, cfg: ArchConfig, kind: str, mesh, prefix_len,
               mask_override, train: bool = True, cache=None):
    """The full-sequence attention on DTensors (training, or a prefill
    that fills ``cache``), the reference's constrain points in its
    order; returns ``x + attention(x)``."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    fb = cfg.attn_fallback
    m = base.axis_size(mesh, "model")

    def heads(t, n):
        if n % m:       # a model-axis shard would cut a head
            t = constrain_act(t, mesh)
        return t.reshape(b, s, n, hd)
    q = constrain_heads(heads(base.matmul(xn, p.wq, train), h), mesh, fb)
    k = constrain_kv(heads(base.matmul(xn, p.wk, train), kv), mesh, fb)
    v = constrain_kv(heads(base.matmul(xn, p.wv, train), kv), mesh, fb)
    if cfg.qk_norm:
        q = base.rms_norm(q, p.q_norm, cfg.norm_eps)
        k = base.rms_norm(k, p.k_norm, cfg.norm_eps)
    q_pl, kv_pl, _ = attention_layout(cfg, mesh)
    theta = layer_theta(cfg, kind)
    q = _rope_local(mesh, theta, base.batch_placed(q, mesh, q_pl))
    k = _rope_local(mesh, theta, base.batch_placed(k, mesh, kv_pl))
    q = constrain_heads(q, mesh, fb)            # the reference's re-pin
    k = constrain_kv(k, mesh, fb)
    mask_kind = _mask_kind(kind, prefix_len, mask_override)
    if cache is not None:
        _prefill_write_mesh(cache, kind, base.batch_placed(k, mesh, kv_pl),
                            base.batch_placed(v, mesh, kv_pl), cfg, mesh)
    if use_context_parallel(cfg, mesh, s):
        o = flash_attention_context_parallel(
            q, k, v, mesh, mask_kind=mask_kind, window=cfg.window,
            prefix_len=prefix_len, logit_cap=cfg.attn_logit_cap,
            q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)
    else:
        o = _attention_mesh(base.batch_placed(q, mesh, q_pl),
                            base.batch_placed(k, mesh, kv_pl),
                            base.batch_placed(v, mesh, kv_pl), cfg, mesh,
                            mask_kind, prefix_len)
    o = o.reshape(b, s, h * hd)
    if h % m != 0:
        # the reference's constraint for "replicate" and "seq"; with "hd"
        # too, or wo's model-sharded gradient would reach the reshape's
        # backward, which cannot split heads the axis does not divide
        o = constrain_act(o, mesh)
    return constrain_act(x + base.matmul(o, p.wo, train), mesh)


def _prefill_write_mesh(cache, kind, k, v, cfg: ArchConfig, mesh):
    """:func:`_prefill_write` of DTensor k, v (B, S, KV, hd) into a
    DTensor cache, each rank its own rows, kv heads, head_dim columns
    or sequence stretch."""
    heads_pl, cols, seq = cache_layout(cache, mesh)
    s0, cap, _ = seq or (0, None, None)
    k, v = (t.redistribute(mesh, base.on_model(t.placements, mesh,
                                               heads_pl)) for t in (k, v))
    names = list(cache)

    def write(kl, vl, *held):
        _prefill_write(dict(zip(names, held)), kind, kl, vl,
                       cfg.kv_cache_dtype == "int8", s0, cap, cols)
    base.local_map(write, mesh, (k, v, *cache.values()))


def _attn_decode_mesh(p, x, xn, cfg: ArchConfig, kind: str, mesh, pos,
                      cache):
    """One decode step on DTensors against a DTensor cache at
    ``cache_specs``' placements: q, k and v on the cache's kv heads (or
    whole over the model axis, a rank then taking its head_dim columns),
    each rank writing and reading its own rows (or sequence stretch);
    returns ``x + attention(x)``."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    int8 = cfg.kv_cache_dtype == "int8"
    heads_pl, cols, seq = cache_layout(cache, mesh)
    s0, cap, seq_group = seq or (0, None, None)
    hd_group = None if cols is None else mesh.get_group("model")
    theta = layer_theta(cfg, kind)

    def heads(t, n):
        if heads_pl != Shard(2) or n % base.axis_size(mesh, "model"):
            t = constrain_act(t, mesh)
        t = t.reshape(b, 1, n, hd)
        want = base.on_model(t.placements, mesh, heads_pl)
        return t if want == tuple(t.placements) else \
            t.redistribute(mesh, want)
    q = heads(base.matmul(xn, p.wq), h)
    k = heads(base.matmul(xn, p.wk), kv)
    v = heads(base.matmul(xn, p.wv), kv)
    if cfg.qk_norm:
        q = base.rms_norm(q, p.q_norm, cfg.norm_eps)
        k = base.rms_norm(k, p.k_norm, cfg.norm_eps)
    names = list(cache)

    def step(ql, kl, vl, pl, *held):
        c = dict(zip(names, held))
        ql = base.rope(ql, pl[:, None].to(torch.float32), theta)
        kl = base.rope(kl, pl[:, None].to(torch.float32), theta)
        valid = _decode_write(c, kind, pl, kl, vl, int8, s0, cap, cols)
        if int8:
            return decode_attention_int8(
                ql, c["k"], c["k_scale"], c["v"], c["v_scale"], valid,
                logit_cap=cfg.attn_logit_cap, hd_cols=cols,
                hd_group=hd_group, seq_group=seq_group)
        return decode_attention(
            ql if cols is None else ql[..., cols], c["k"], c["v"], valid,
            logit_cap=cfg.attn_logit_cap, head_dim=hd, hd_group=hd_group,
            seq_group=seq_group)
    o = base.local_map(step, mesh, (q, k, v, pos, *cache.values()),
                       base.on_model(q.placements, mesh, heads_pl
                                     if cols is None else Shard(3)))
    o = constrain_act(o, mesh) if cols is not None else o
    return x + base.matmul(o.reshape(b, 1, h * hd), p.wo)


def attn_apply(p, x, cfg: ArchConfig, kind: str, mode: str,
               positions=None, pos=None, cache=None, prefix_len=None,
               mask_override=None, mesh=None):
    """Returns ``x + attention(x)``; fills ``cache`` in place (keys are
    roped before caching).  A global layer takes the prefix-LM mask when
    ``prefix_len`` is set; ``mask_override`` replaces the mask kind.
    On a ``mesh`` (DTensor ``x``; a DTensor ``cache`` at
    ``cache_specs``' placements and ``pos`` at ``batch_spec``'s) every
    mode runs on each rank's shards."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    theta = layer_theta(cfg, kind)
    int8 = cfg.kv_cache_dtype == "int8"
    train = mode == "train"
    xn = base.rms_norm(x, p.norm, cfg.norm_eps)
    if mesh is not None and mode == "decode":
        return _attn_decode_mesh(p, x, xn, cfg, kind, mesh, pos, cache)
    if mesh is not None:
        return _attn_mesh(p, x, xn, cfg, kind, mesh, prefix_len,
                          mask_override, train, cache)
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
        mask_kind = _mask_kind(kind, prefix_len, mask_override)
        o = flash_attention(
            q, k, v, mask_kind=mask_kind, window=cfg.window,
            prefix_len=prefix_len, logit_cap=cfg.attn_logit_cap,
            q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
            schedule=cfg.attn_schedule)
        if cache is not None:
            _prefill_write(cache, kind, k, v, int8)
    return x + base.matmul(o.reshape(b, s, h * hd), p.wo, train)


def mlp_apply(p, x, cfg: ArchConfig, train: bool = False, mesh=None):
    xn = base.rms_norm(x, p.norm, cfg.norm_eps)
    return constrain_act(x + base.swiglu(xn, p.w_gate, p.w_up, p.w_down,
                                         train), mesh)


def layer_apply(layer, x, cfg: ArchConfig, mode: str, mesh=None, **kw):
    """Returns (x, aux): aux is an MoE layer's router z-loss, else 0."""
    from . import moe
    x = attn_apply(layer.attn, x, cfg, layer.kind, mode, mesh=mesh, **kw)
    if cfg.family == "moe":
        return moe.moe_apply(layer.moe, x, cfg, decode=(mode == "decode"),
                             train=(mode == "train"), mesh=mesh)
    return mlp_apply(layer.mlp, x, cfg, mode == "train", mesh), 0.0


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

def embed_tokens(model, tokens, cfg: ArchConfig, scale: bool, mesh=None):
    """The rows of ``tokens``; on a ``mesh`` each rank looks up the
    tokens in its shard of the vocabulary (zeros elsewhere) and the
    model axis sums them: one non-zero term, the row's bits."""
    def lookup(w, toks, v0=None):
        if v0 is None:
            x = w[toks]
        else:
            idx = toks.long() - v0
            mine = (idx >= 0) & (idx < w.shape[0])
            x = torch.where(mine[..., None],
                            w[idx.clamp(0, w.shape[0] - 1)], 0.0)
        if scale:    # sqrt(d_model) in float32, rounded to the working dtype
            x = x * torch.full((), math.sqrt(cfg.d_model),
                               dtype=torch.float32,
                               device=x.device).to(x.dtype)
        return x
    if mesh is None:
        return lookup(model.embed, tokens)
    w = base.gathered(model.embed)
    pls, v0 = tokens.placements, None
    if base.model_sharded(w, mesh):
        v0 = mesh.get_local_rank("model") * w.to_local().shape[0]
        pls = base.on_model(pls, mesh, base.Partial())
    x = base.local_map(lambda wl, tl: lookup(wl, tl, v0), mesh,
                       (w, tokens), pls)
    return constrain_act(x, mesh)


def unembed_matrix(model, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return model.embed.T
    return model.unembed


def loss_mask(batch) -> torch.Tensor:
    """``batch["mask"]``, or float32 ones shaped as the labels."""
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(batch["labels"], dtype=torch.float32)
    return mask


def lm_train_loss(model, batch, cfg: ArchConfig, embed_scale: bool = False,
                  mesh=None):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``
    (B, S), optional float ``mask``); an MoE adds
    ``router_aux_coef * aux / n_layers``."""
    tokens, labels = batch["tokens"], batch["labels"]
    mask = loss_mask(batch)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed_tokens(model, tokens, cfg, embed_scale, mesh)
    x, aux = stack_apply(model.layers, x, cfg, "train", positions=positions,
                         mesh=mesh)
    x = base.rms_norm(x, model.final_norm, cfg.norm_eps)
    w = unembed_matrix(model, cfg)
    ce = base.cross_entropy_chunked(
        lambda xs: base.matmul(xs, w, train=True), x, labels, mask,
        chunk=cfg.ce_chunk, final_cap=cfg.final_logit_cap, mesh=mesh)
    if cfg.family == "moe":
        ce = ce + cfg.router_aux_coef * aux / cfg.n_layers
    return ce


def last_logits(model, x, cfg: ArchConfig, mesh=None):
    """(B, V) logits of the last position of ``x`` (B, S, D); on a mesh
    at the reference's output placements (batch over the data axes,
    whole vocabulary)."""
    x = base.rms_norm(x[:, -1:], model.final_norm, cfg.norm_eps)
    logits = base.softcap(base.matmul(x, unembed_matrix(model, cfg)),
                          cfg.final_logit_cap)[:, 0]
    return constrain(logits, mesh, "batch", None)


def lm_prefill(model, tokens, cfg: ArchConfig, s_cap=None,
               embed_scale: bool = False, prefix_len=None, mesh=None):
    """Returns (caches, last_token_logits); on a ``mesh`` (DTensor
    ``tokens``) DTensor caches at ``cache_specs``' placements."""
    b, s = tokens.shape
    s_cap = s_cap or cfg.max_seq
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    caches = init_cache(lm_cache_spec(cfg, b, s_cap), tokens.device, mesh)
    x = embed_tokens(model, tokens, cfg, embed_scale, mesh)
    x, _ = stack_apply(model.layers, x, cfg, "prefill", caches=caches,
                       positions=positions, prefix_len=prefix_len,
                       mesh=mesh)
    return caches, last_logits(model, x, cfg, mesh)


def lm_decode_step(model, caches, token, pos, cfg: ArchConfig,
                   embed_scale: bool = False, mesh=None):
    """token: (B,) int, pos: (B,) int.  Returns (caches, logits (B, V));
    ``caches`` is updated in place and returned."""
    x = embed_tokens(model, token[:, None], cfg, embed_scale, mesh)
    x, _ = stack_apply(model.layers, x, cfg, "decode", caches=caches,
                       pos=pos, mesh=mesh)
    return caches, last_logits(model, x, cfg, mesh)
