"""Chunked (flash-style) attention in plain PyTorch, GQA-native.

The same functions as the JAX package's ``models/attention.py``, in its
layouts.  Two schedules compute the same function:

  * "masked"  -- every (q_chunk, kv_chunk) pair, masked inside the chunk.
  * "banded"  -- only the chunk pairs that can contain unmasked entries
                 (triangular band for causal, diagonal band for
                 sliding-window), from the same static ``_band_pairs``.

The reference's rounding points stay: scores and P.V from working-dtype
operands (exact products), scores in float32, P = exp(s - max) rounded
to the working dtype before P.V.  Its online softmax does not: a first
pass over a row's chunks takes the row's max, a second sums
``P`` and ``P.V`` in float64, which is exact up to the last bits of
float64 whatever the order.  So a row's result does not depend on the
chunking, on how many masked slots ride along or on a ring cache's
order, and :func:`decode_attention` (one chunk: the cache) gives a
prefill row's bits.  With the reference's float32 rescaling, those
differences alone part decode from prefill by 0.06 of the logits' std
over gemma3-1b's 26 layers at a 1,024-token prefix (H100).  The chunk
loops are Python loops over static chunk indices.

``decode_attention_int8``'s integer dots go through :func:`int_einsum`,
exact on both devices.  Scales divide by tensors on the operands' device
(CUDA divides by a CPU scalar as a multiply by its reciprocal).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from .base import batch_placed, local_map, mesh_names, mesh_shape

NEG_INF = -1e30


def _chunk_mask(qpos, kpos, kind: str, window, prefix_len):
    """Boolean mask (..., qc, kc): True = attend."""
    if kind == "none":
        return None
    q = qpos[..., :, None]
    k = kpos[..., None, :]
    causal = k <= q
    if kind == "causal":
        m = causal
    elif kind == "local":
        m = causal & (k > q - window)
    elif kind == "prefix":
        m = causal | (k < prefix_len)
    else:
        raise ValueError(kind)
    return m


def _all_reduce(t, group, op=None):
    """``t`` summed (or ``op``) over ``group`` in place; ``t`` itself
    when ``group`` is ``None``."""
    if group is not None:
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=group)
    return t


def _score_block(q_blk, k_blk, scale, logit_cap, msk, hd_group=None):
    # q_blk: (B, qc, KV, G, D), k_blk: (B, kc, KV, D), float64 copies of
    # the working-dtype values -> (B, KV, G, qc, kc) float32; with
    # ``hd_group`` D is this rank's share of head_dim and the float64
    # dots are summed over the group before they round
    s = _all_reduce(torch.einsum("bqkgd,bskd->bkgqs", q_blk, k_blk),
                    hd_group).to(torch.float32) * scale
    if logit_cap is not None:
        s = torch.tanh(s / logit_cap) * logit_cap
    if msk is not None:
        s = torch.where(msk, s, NEG_INF)
    return s


def _pv_block(p, v_blk, dtype):
    # p: (B, KV, G, qc, kc) f32, rounded to the working ``dtype``; v_blk:
    # (B, kc, KV, D), a float64 copy of working-dtype values
    return torch.einsum("bkgqs,bskd->bkgqd",
                        p.to(dtype).to(torch.float64), v_blk)


def _band_pairs(n_q: int, n_k: int, kind: str, window, k_chunk: int,
                prefix_len) -> list:
    """Chunk pairs that may contain unmasked entries (static)."""
    pairs = []
    band = None
    if kind == "local" and window is not None:
        band = -(-window // k_chunk)           # chunks back from diagonal
    prefix_chunks = 0
    if kind == "prefix" and prefix_len:
        prefix_chunks = -(-prefix_len // k_chunk)
    for qi in range(n_q):
        for ki in range(n_k):
            if kind == "none":
                pairs.append((qi, ki))
                continue
            diag = (qi * n_k) // n_q            # kv chunk containing diagonal
            if ki > diag and ki >= prefix_chunks:
                continue                        # fully in the future
            if band is not None and ki < diag - band and ki >= prefix_chunks:
                continue                        # fully outside the window
            pairs.append((qi, ki))
    return pairs


def flash_attention(q, k, v, *, mask_kind: str = "causal",
                    window: int | None = None, prefix_len: int | None = None,
                    logit_cap: float | None = None,
                    q_chunk: int = 512, k_chunk: int = 512,
                    schedule: str = "masked", q_offset: int = 0,
                    k_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D) -> (B, Sq, H, D).

    H must be a multiple of KV (GQA groups are never materialized).
    q_offset/k_offset shift the absolute positions of q/k rows ("banded"
    requires offsets of 0).
    """
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    dtype = v.dtype
    # float64 copies made once: autograd then keeps one of each, not one
    # a chunk pair
    q = q.reshape(b, sq, kv, g, d).to(torch.float64)
    k, v = k.to(torch.float64), v.to(torch.float64)

    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, sk)
    if sq % q_chunk or sk % k_chunk:
        q_chunk, k_chunk = sq, sk               # fallback: single chunk
    n_q, n_k = sq // q_chunk, sk // k_chunk
    if schedule == "banded" and mask_kind != "none":
        pairs = _band_pairs(n_q, n_k, mask_kind, window, k_chunk, prefix_len)
        q_offset = k_offset = 0
    else:
        pairs = [(qi, ki) for qi in range(n_q) for ki in range(n_k)]

    def blocks():
        for qi, ki in pairs:
            qpos = q_offset + qi * q_chunk + torch.arange(q_chunk,
                                                          device=q.device)
            kpos = k_offset + ki * k_chunk + torch.arange(k_chunk,
                                                          device=q.device)
            msk = _chunk_mask(qpos, kpos, mask_kind, window, prefix_len)
            yield qi, ki, _score_block(q[:, qi * q_chunk:(qi + 1) * q_chunk],
                                       k[:, ki * k_chunk:(ki + 1) * k_chunk],
                                       scale, logit_cap, msk)

    m = [torch.full((b, kv, g, q_chunk, 1), NEG_INF, device=q.device)
         for _ in range(n_q)]
    # pass 1: each row's max.  It only shifts the exponents, and its
    # gradient cancels, so autograd does not record it.
    with torch.no_grad():
        for qi, _, s in blocks():
            m[qi] = torch.maximum(m[qi], s.amax(-1, keepdim=True))
    l = [0.0] * n_q
    acc = [0.0] * n_q
    for qi, ki, s in blocks():                 # pass 2: float64 sums
        p = torch.exp(s - m[qi])
        l[qi] = l[qi] + p.sum(-1, dtype=torch.float64)
        acc[qi] = acc[qi] + _pv_block(
            p, v[:, ki * k_chunk:(ki + 1) * k_chunk], dtype)
    # (B, KV, G, qc, D) -> (B, qc, KV, G, D), chunks along the sequence
    out = torch.cat([(a / torch.clamp(n, min=1e-30)[..., None])
                     .permute(0, 3, 1, 2, 4) for n, a in zip(l, acc)], dim=1)
    return out.reshape(b, sq, h, d).to(dtype)


def flash_attention_context_parallel(
        q, k, v, mesh, *, mask_kind: str = "causal",
        window: int | None = None, prefix_len: int | None = None,
        logit_cap: float | None = None, q_chunk: int = 512,
        k_chunk: int = 512):
    """Context-parallel attention of DTensors q (B, S, H, D), k, v
    (B, S, KV, D) on ``mesh``: q sharded over the sequence on the model
    axis, k and v replicated over it (all batch-sharded over the data
    axes, as they come).  Each rank computes its own sequence slice
    with offset masks (``schedule="masked"``): no collective inside the
    attention, its work divided by the model axis's size.  A
    sliding-window layer's rank reads only the (S/n + window) keys it
    can see.  Returns the output at q's placements.

    With one rank on the model axis, or a sequence it does not divide,
    this is :func:`flash_attention` on each rank's rows, all heads.
    """
    n = mesh_shape(mesh)["model"] if "model" in mesh_names(mesh) else 1
    s = q.shape[1]
    kw = dict(mask_kind=mask_kind, window=window, prefix_len=prefix_len,
              logit_cap=logit_cap, k_chunk=k_chunk)
    k, v = batch_placed(k, mesh, Replicate()), batch_placed(
        v, mesh, Replicate())
    if n <= 1 or s % n or (s // n) < 1:
        q = batch_placed(q, mesh, Replicate())
        return local_map(
            lambda ql, kl, vl: flash_attention(ql, kl, vl, q_chunk=q_chunk,
                                               **kw),
            mesh, (q, k, v), q.placements)
    s_loc = s // n
    off = mesh.get_local_rank("model") * s_loc
    k_off, klen = 0, s
    if mask_kind == "local" and window is not None and window < s:
        klen = min(s, s_loc + -(-window // k_chunk) * k_chunk)
        k_off = min(max(off + s_loc - klen, 0), s - klen)

    def local(ql, kl, vl):
        return flash_attention(
            ql, kl[:, k_off:k_off + klen], vl[:, k_off:k_off + klen],
            q_chunk=min(q_chunk, s_loc), schedule="masked", q_offset=off,
            k_offset=k_off, **kw)
    q = batch_placed(q, mesh, Shard(1))
    return local_map(local, mesh, (q, k, v), q.placements)


def int_einsum(equation: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """Exact integer einsum of int8 operands -> int32.

    On the CPU the sums run in int64.  CUDA has no batched integer
    matmul, so there they run in float64, exact while every sum stays
    below 2^53 (int8 products are at most 127^2, so any contraction
    shorter than 5.5e11 terms); float32 would be exact only below 2^24,
    about 1,040 terms of P.V.
    """
    if a.device.type == "cpu":
        return torch.einsum(equation, a.to(torch.int64),
                            b.to(torch.int64)).to(torch.int32)
    out = torch.einsum(equation, a.to(torch.float64), b.to(torch.float64))
    return out.to(torch.int32)


def _quant_rows(xf):
    """Symmetric int8 over the last axis of float32 ``xf``: (q, scale),
    scale keeping the reduced axis."""
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.where(amax == 0, 1.0, amax / amax.new_full((), 127.0))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decode_attention_int8(q, k_q, k_scale, v_q, v_scale, valid, *,
                          logit_cap: float | None = None,
                          hd_cols: slice | None = None, hd_group=None,
                          seq_group=None) -> torch.Tensor:
    """Integer-domain decode attention over an int8 KV cache.

    The int8 QK^T dot is the PPM, the int32 accumulator the carry-free
    compressor, and the per-row scales applied after the dot the final
    adder.  The P.V contraction folds V's per-position scales into the
    probabilities before quantizing them, so both large reads (K and V
    caches) stay int8 end to end.

    q: (B, 1, H, D) bf16;  k_q/v_q: (B, S, KV, D) int8;
    k_scale/v_scale: (B, S, KV) f32;  valid: (B, S) bool.

    On sharded caches (the mesh's decode): ``hd_cols`` are the columns of
    head_dim the caches hold (q is quantized whole, then sliced) and the
    integer dots are summed over ``hd_group``; with ``seq_group`` the
    caches hold a stretch of the sequence and the softmax's max and sum,
    the probabilities' max and the integer P.V sum over it.
    """
    b, _, h, d = q.shape
    s, kv = k_q.shape[1], k_q.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, 1, kv, g, d)
    q8, qs = _quant_rows(qg.to(torch.float32))    # per (b, kv, g) row
    if hd_cols is not None:
        q8 = q8[..., hd_cols]

    scores_i = _all_reduce(int_einsum("bqkgd,bskd->bkgqs", q8, k_q),
                           hd_group)
    qs_b = qs[:, 0][..., None]                             # (B,KV,G,1,1)
    ks_b = k_scale.permute(0, 2, 1)[:, :, None, None, :]   # (B,KV,1,1,S)
    scores = scores_i.to(torch.float32) * qs_b * ks_b * scale
    if logit_cap is not None:
        scores = torch.tanh(scores / logit_cap) * logit_cap
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    if seq_group is None:
        probs = torch.softmax(scores, dim=-1)              # (B,KV,G,1,S)
    else:
        top = _all_reduce(scores.amax(-1, keepdim=True), seq_group,
                          dist.ReduceOp.MAX)
        e = torch.exp(scores - top)
        probs = e / _all_reduce(e.sum(-1, keepdim=True), seq_group)
    # fold V scales into probs, then quantize probs
    pv = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    pmax = _all_reduce(torch.amax(pv, dim=-1, keepdim=True), seq_group,
                       dist.ReduceOp.MAX)
    ps = torch.where(pmax == 0, 1.0, pmax / pmax.new_full((), 127.0))
    p8 = torch.clamp(torch.round(pv / ps), -127, 127).to(torch.int8)
    out_i = _all_reduce(int_einsum("bkgqs,bskd->bqkgd", p8, v_q),
                        seq_group)
    out = out_i.to(torch.float32) \
        * torch.movedim(ps, 4, 1).reshape(b, 1, kv, g, 1)
    return out.reshape(b, 1, h, -1).to(torch.bfloat16)


def decode_attention(q, k_cache, v_cache, valid, *,
                     logit_cap: float | None = None, head_dim=None,
                     hd_group=None, seq_group=None) -> torch.Tensor:
    """Single-token attention over a (possibly ring) KV cache.

    q: (B, 1, H, D); k_cache/v_cache: (B, S, KV, D) with keys pre-roped;
    valid: (B, S) bool -- which cache slots hold live entries.

    The cache is one chunk of :func:`flash_attention`, so a decode row
    rounds as the same row of a prefill.  (The JAX package's
    ``decode_attention`` rounds the normalized softmax to the working
    dtype instead of P = exp(s - max), which alone parts its decode from
    its prefill by 0.15 of the logits' std over gemma2-9b's 42 layers.)

    On sharded caches (the mesh's decode): with ``hd_group`` q and the
    caches hold a share of head_dim (``head_dim`` the whole, for the
    scale) and the scores are float64 partial sums over the group; with
    ``seq_group`` the caches hold a stretch of the sequence, and the
    ranks' max, float64 sum and P.V merge over the group (a log-sum-exp
    whose exponents are those of the whole cache).
    """
    b, _, h, d = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    s = _score_block(q.reshape(b, 1, kv, g, d).to(torch.float64),
                     k_cache.to(torch.float64),
                     1.0 / math.sqrt(head_dim or d), logit_cap,
                     valid[:, None, None, None, :], hd_group)
    p = torch.exp(s - _all_reduce(s.amax(-1, keepdim=True), seq_group,
                                  dist.ReduceOp.MAX))
    out = _all_reduce(_pv_block(p, v_cache.to(torch.float64),
                                v_cache.dtype), seq_group) \
        / _all_reduce(p.sum(-1, dtype=torch.float64), seq_group)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, d).to(v_cache.dtype)
