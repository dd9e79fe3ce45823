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

The reference's shard-local dispatch (``_expert_choice_local``) runs
only with a device mesh; the port has none yet (ROADMAP queue 1, the
launch tooling), so ``moe_local_dispatch`` takes :func:`_expert_choice`,
which is what the reference does without a mesh.
"""
from __future__ import annotations

import torch

from . import base
from .base import Param
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


def _expert_ffn(xg, p, train: bool = False):
    """xg: (E, C, D) tokens grouped per expert -> (E, C, D)."""
    return torch.stack([base.swiglu(xg[e], p.w_gate[e], p.w_up[e],
                                    p.w_down[e], train)
                        for e in range(xg.shape[0])])


def moe_apply(p, x, cfg: ArchConfig, decode: bool = False,
              train: bool = False):
    """Returns (x + moe(x), router_z_loss); ``train`` makes each
    projection one matmul call (``base.matmul``)."""
    b, s, d = x.shape
    xn = base.rms_norm(x, p.norm, cfg.norm_eps)
    logits = base.matmul(xn.to(torch.float32), p.router, train)  # (B,S,E)
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    if decode or b * s <= 4 * cfg.n_experts:
        y = _dense_token_choice(p, xn, logits, cfg, train)
    else:
        y = _expert_choice(p, xn, logits, cfg, train)

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


def _expert_choice(p, xn, logits, cfg: ArchConfig, train: bool = False):
    """Expert-choice dispatch: top-C tokens per expert, C = T*top_k/E."""
    b, s, d = xn.shape
    t = b * s
    e = cfg.n_experts
    c = max(1, (t * cfg.top_k) // e)
    xf = xn.reshape(t, d)
    affin = torch.softmax(logits.reshape(t, e), dim=-1)     # (T, E)
    gate, idx = top_k(affin.T, c)                            # (E, C)
    y = _expert_ffn(xf[idx], p, train)                       # (E, C, D)
    y = y * gate[..., None].to(y.dtype)
    return combine(y, idx, t).reshape(b, s, d)


def combine(y, idx, t: int):
    """Scatter-add of expert rows ``y`` (E, C, D) to tokens ``idx`` (E, C)
    -> (t, D): float32 sums, expert by expert, rounded once.  An expert's
    ``C`` indices are distinct, so no two adds of one ``index_add_`` meet
    at a row."""
    out = torch.zeros((t, y.shape[-1]), dtype=torch.float32,
                      device=y.device)
    for e in range(y.shape[0]):
        out.index_add_(0, idx[e], y[e].to(torch.float32))
    return out.to(y.dtype)

