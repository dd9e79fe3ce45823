"""Mixture-of-Experts blocks (dbrx 16e top-4, llama4-scout 16e top-1).

Two dispatch paths, as in the JAX package's ``models/moe.py``:

  * prefill with more than ``4 * n_experts`` tokens: **expert-choice**
    routing -- each expert selects its top-C tokens (C = T * top_k / E).
  * decode, and short prefills: dense token-choice top-k combine over
    every expert's output.

Ties in a top-k take the lower index first, as ``jax.lax.top_k`` does
(a stable descending sort).  The expert-choice combine sums the experts'
rows in float32, one expert after another, and rounds once: every row
of one expert's scatter is a distinct token, so the sum has a fixed
order and the card gives the same bits on every call.

Expert choice (:func:`_expert_choice_local`) decides the routing within
each of ``groups`` groups of tokens: one group is the reference's
global dispatch, and the data shards of a mesh its
``moe_local_dispatch``; without a mesh the count is explicit, so one
process computes the routing a mesh does.

On a mesh (DTensors; serving too) the reference's constrain points become
``redistribute`` calls: the experts split over the model axis (each
rank computes its own experts' rows), the routing and the gather and
scatter run on each rank's tokens (:func:`base.local_map`), and the
combine sums each rank's experts in float32 before the model axis's
reduce-scatter, then rounds once.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Partial, Replicate

from . import base
from .base import Param, constrain
from ..configs.base import ArchConfig


def moe_template(cfg: ArchConfig) -> dict:
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    t = {
        "norm": Param((d,), (None,), init="zeros"),
        "router": Param((d, e), ("fsdp", None), dtype=torch.float32),
        "w_gate": Param((e, d, fe), ("model", "fsdp", None)),
        "w_up": Param((e, d, fe), ("model", "fsdp", None)),
        "w_down": Param((e, fe, d), ("model", None, "fsdp"), init="scaled"),
    }
    if cfg.n_shared_experts:
        f = cfg.d_ff * cfg.n_shared_experts
        t["shared"] = {
            "w_gate": Param((d, f), ("fsdp", "model")),
            "w_up": Param((d, f), ("fsdp", "model")),
            "w_down": Param((f, d), ("model", "fsdp"), init="scaled"),
        }
    return t


def top_k(x, k: int):
    """(values, indices) of the ``k`` largest along the last axis, the
    lower index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_logits(xn, router, mesh=None):
    """(B, S, E) float32 router logits, by :func:`base.matmul`'s
    fixed-shape calls in training too: a token's logits then have the
    same bits in a mesh's data shard as in one process, and expert
    choice picks the same tokens there (one call over all the rows lets
    cuBLAS pick its kernel by the row count, and a logit that rounds
    apart can move a token at an expert's capacity edge).  The router is
    float32, so its gradient loses nothing to the calls."""
    xf = xn.to(torch.float32)
    if mesh is None:
        return base.matmul(xf, router)
    return base.local_map(base.matmul, mesh, (xf, base.gathered(router)),
                          xf.placements)


def moe_apply(p, x, cfg: ArchConfig, decode: bool = False,
              train: bool = False, mesh=None, groups: int = 1):
    """Returns (x + moe(x), router_z_loss); ``train`` makes each expert
    projection one matmul call (``base.matmul``); a ``mesh`` (DTensor
    ``x``, training) splits the experts over its model axis.  Without a
    mesh, expert choice routes within ``groups`` groups of the tokens:
    1 is the reference's dispatch, and the size of a mesh's data axes
    gives the routing of its ``moe_local_dispatch``."""
    b, s, d = x.shape
    xn = base.rms_norm(x, p.norm, cfg.norm_eps)
    logits = router_logits(xn, p.router, mesh)                 # (B,S,E)
    if mesh is not None:
        return _moe_mesh(p, x, xn, logits, cfg, mesh, decode, train)
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    if decode or b * s <= 4 * cfg.n_experts:
        y = _dense_token_choice(p, xn, logits, cfg, train)
    else:
        y = _expert_choice_local(p, xn, logits, cfg, groups, train)

    if cfg.n_shared_experts:
        y = y + base.swiglu(xn, p.shared.w_gate, p.shared.w_up,
                            p.shared.w_down, train)
    return x + y.to(x.dtype), zloss


def _dense_token_choice(p, xn, logits, cfg: ArchConfig,
                        train: bool = False):
    """All-experts compute + sparse top-k combine (decode path)."""
    topv, topi = top_k(logits, cfg.top_k)                    # (B, S, K)
    if cfg.top_k == 1:
        gates = torch.sigmoid(topv)                          # llama4-style
    else:
        gates = torch.softmax(topv, dim=-1)                  # dbrx-style
    w = torch.zeros_like(logits).scatter_(-1, topi, gates).to(xn.dtype)
    # the reference's (B, S, E, D) einsum over experts: products of bf16
    # values summed in float32, one rounding
    acc = torch.zeros(xn.shape, dtype=torch.float32, device=xn.device)
    for e in range(cfg.n_experts):
        y = base.swiglu(xn, p.w_gate[e], p.w_up[e], p.w_down[e], train)
        acc += y.to(torch.float32) * w[..., e:e + 1].to(torch.float32)
    return acc.to(xn.dtype)


# ---------------------------------------------------------- expert choice

def _route(xg, lg, cl: int):
    """Expert choice within each group: xg (G, tl, D), lg (G, tl, E) ->
    (picked rows (G, E, Cl, D), gates (G, E, Cl), token indices)."""
    affin = torch.softmax(lg, dim=-1)
    gate, idx = top_k(affin.transpose(1, 2), cl)             # (G, E, Cl)
    rows = torch.arange(xg.shape[0], device=xg.device)[:, None, None]
    return xg[rows, idx], gate, idx


def _group_ffn(picked, w_gate, w_up, w_down, train: bool):
    """picked (G, E, Cl, D) against E experts' weights -> (G, E, Cl, D)."""
    return torch.stack([base.swiglu(picked[:, e], w_gate[e], w_up[e],
                                    w_down[e], train)
                        for e in range(picked.shape[1])], dim=1)


def _group_combine(y, idx, tl: int):
    """Scatter-add of y (G, E, Cl, D) to tokens idx (G, E, Cl) of each
    group -> float32 (G, tl, D), expert by expert (an expert's rows are
    distinct tokens; every group's at once)."""
    g, e = idx.shape[:2]
    out = torch.zeros((g * tl, y.shape[-1]), dtype=torch.float32,
                      device=y.device)
    base_row = (torch.arange(g, device=y.device) * tl)[:, None]
    for j in range(e):
        out.index_add_(0, (idx[:, j] + base_row).reshape(-1),
                       y[:, j].reshape(-1, y.shape[-1]).to(torch.float32))
    return out.reshape(g, tl, -1)


def _expert_choice_local(p, xn, logits, cfg: ArchConfig, groups: int,
                         train: bool = False):
    """Shard-local expert choice in one process: the tokens (batch-major)
    fall into ``groups`` equal groups, the data shards of a mesh with
    ``groups`` ranks over its data axes, and each expert picks its top
    Cl = max(1, tl * top_k / E) tokens of each group (tl = T / groups).
    The reference's ``_expert_choice_local`` on a mesh of that size."""
    b, s, d = xn.shape
    t, e = b * s, cfg.n_experts
    tl = t // groups
    cl = max(1, (tl * cfg.top_k) // e)
    picked, gate, idx = _route(xn.reshape(groups, tl, d),
                               logits.reshape(groups, tl, e), cl)
    y = _group_ffn(picked, p.w_gate, p.w_up, p.w_down, train)
    y = y * gate[..., None].to(y.dtype)
    return _group_combine(y, idx, tl).to(xn.dtype).reshape(b, s, d)


# ------------------------------------------------------------------ mesh

def _experts(p, mesh):
    """The expert weights gathered over the data axes, each rank's
    experts on the model axis, and the first expert this rank holds."""
    ws = [base.gathered(w) for w in (p.w_gate, p.w_up, p.w_down)]
    first = 0
    if base.model_sharded(ws[0], mesh):
        first = mesh.get_local_rank("model") * ws[0].to_local().shape[0]
    return ws, first


def _moe_mesh(p, x, xn, logits, cfg: ArchConfig, mesh, decode=False,
              train=True):
    """:func:`moe_apply` on DTensors.  Serving (``train`` off) takes
    :func:`base.matmul`'s fixed-shape calls and skips the z-loss, which
    only training reads (its sum would cost an all-reduce a layer)."""
    b, s, d = x.shape
    e = cfg.n_experts
    data = tuple(base.mesh_names(mesh)[i] for i, pl in
                 enumerate(xn.placements) if pl.is_shard())
    zloss = 0.0
    if train:
        zsum = base.local_map(
            lambda lg: torch.sum(torch.logsumexp(lg, dim=-1) ** 2), mesh,
            (logits,))
        zloss = base.psum(zsum, mesh, data) / (b * s)
    g = base.axis_size(mesh, data)
    if decode or b * s <= 4 * e:
        y = _dense_token_choice_mesh(p, xn, logits, cfg, mesh, train)
    elif cfg.moe_local_dispatch and g > 1 and b % g == 0:
        y = _expert_choice_local_mesh(p, xn, logits, cfg, mesh, g, train)
    else:
        y = _expert_choice_mesh(p, xn, logits, cfg, mesh, train)
    if cfg.n_shared_experts:
        y = y + base.swiglu(xn, p.shared.w_gate, p.shared.w_up,
                            p.shared.w_down, train)
    return constrain(x + y.to(x.dtype), mesh, "batch", None, None), zloss


def _dense_token_choice_mesh(p, xn, logits, cfg: ArchConfig, mesh,
                             train=True):
    """Token choice on DTensors: each rank its tokens and its experts,
    float32 sums over the model axis."""
    ws, first = _experts(p, mesh)

    def fn(xl, lg, wg, wu, wd):
        topv, topi = top_k(lg, cfg.top_k)
        gates = torch.sigmoid(topv) if cfg.top_k == 1 \
            else torch.softmax(topv, dim=-1)
        w = torch.zeros_like(lg).scatter_(-1, topi, gates).to(xl.dtype)
        acc = torch.zeros(xl.shape, dtype=torch.float32, device=xl.device)
        for j in range(wg.shape[0]):
            y = base.swiglu(xl, wg[j], wu[j], wd[j], train)
            acc += y.to(torch.float32) \
                * w[..., first + j:first + j + 1].to(torch.float32)
        return acc
    split = base.model_sharded(ws[0], mesh)
    out = base.local_map(fn, mesh, (xn, logits, *ws), base.on_model(
        xn.placements, mesh, Partial() if split else Replicate()))
    return base.reduced(out).to(xn.dtype)


def _expert_choice_local_mesh(p, xn, logits, cfg: ArchConfig, mesh, g,
                              train=True):
    """The reference's ``_expert_choice_local`` on DTensors: each data
    shard routes its own tokens; the picked rows go to their experts'
    model ranks (a slice: the tokens are replicated over the model
    axis), and the combine reduce-scatters over the model axis in
    float32."""
    b, s, d = xn.shape
    e = cfg.n_experts
    tl = b * s // g
    cl = max(1, (tl * cfg.top_k) // e)
    xg = constrain(xn, mesh, "batch", None, None)
    pls = xg.placements

    def route(xl, lg):
        return _route(xl.reshape(1, tl, d), lg.reshape(1, tl, e), cl)
    picked, gate, idx = base.local_map(route, mesh, (xg, logits),
                                       [pls, pls, pls])
    picked = constrain(picked, mesh, "batch", "model", None, None)
    gate = constrain(gate, mesh, "batch", "model", None)
    idx = constrain(idx, mesh, "batch", "model", None)
    ws, _ = _experts(p, mesh)
    y = base.local_map(lambda pl_, wg, wu, wd: _group_ffn(pl_, wg, wu, wd,
                                                          train),
                       mesh, (picked, *ws), picked.placements)
    y = constrain(y, mesh, "batch", "model", None, None)
    y = y * gate[..., None].to(y.dtype)
    split = base.model_sharded(y, mesh)
    out = base.local_map(
        lambda yl, il: _group_combine(yl, il, tl).reshape(-1, s, d),
        mesh, (y, idx),
        base.on_model(pls, mesh, Partial() if split else Replicate()))
    out = constrain(out, mesh, "batch", None, "model")
    return constrain(out.to(xn.dtype), mesh, "batch", None, None)


def _expert_choice_mesh(p, xn, logits, cfg: ArchConfig, mesh, train=True):
    """Global expert choice on DTensors (the reference's
    ``_expert_choice`` under a mesh): every rank routes all the tokens;
    the picked rows shard over (experts on "model", capacity on
    "fsdp"), and the float32 combine is reduced to the batch's shards."""
    b, s, d = xn.shape
    t, e = b * s, cfg.n_experts
    c = max(1, (t * cfg.top_k) // e)
    everywhere = tuple(Replicate() for _ in base.mesh_names(mesh))
    xa = xn.redistribute(mesh, everywhere)
    la = logits.redistribute(mesh, everywhere)

    def route(xl, lg):
        picked, gate, idx = _route(xl.reshape(1, t, d), lg.reshape(1, t, e),
                                   c)
        return picked[0], gate[0], idx[0]
    picked, gate, idx = base.local_map(route, mesh, (xa, la),
                                       [everywhere] * 3)
    picked = constrain(picked, mesh, "model", "fsdp", None)
    gate = constrain(gate, mesh, "model", "fsdp")
    idx = constrain(idx, mesh, "model", "fsdp")
    ws, _ = _experts(p, mesh)
    y = base.local_map(
        lambda pl_, wg, wu, wd: _group_ffn(pl_[None], wg, wu, wd,
                                           train)[0],
        mesh, (picked, *ws), picked.placements)
    y = constrain(y, mesh, "model", "fsdp", None)
    y = y * gate[..., None].to(y.dtype)
    out_pls = tuple(Partial() if pl.is_shard() else Replicate()
                    for pl in y.placements)
    out = base.local_map(
        lambda yl, il: _group_combine(yl[None], il[None], t)[0], mesh,
        (y, idx), out_pls)
    # the rows of xn's batch shards (a batch the data axes do not divide
    # stays whole, as xn)
    out = out.redistribute(mesh, tuple(pl if pl.is_shard(0) else Replicate()
                                       for pl in xn.placements))
    return out.to(xn.dtype).reshape(b, s, d)
