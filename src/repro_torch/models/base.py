"""Parameter templates and the common NN primitives of the model stack.

A model is described by a *template*: a nested dict whose leaves are
:class:`Param` descriptors carrying shape, dtype, logical sharding axes
and an initializer, as in the JAX package's ``models/base.py``.  The
port derives from one template the parameter count and the initial
values (:func:`initialize_`); :class:`repro_torch.models.Model` holds
the values as ``nn.Parameter``s under the template's leaf names.

The primitives compute in float32 and cast back to the input's dtype at
the reference's points (``rms_norm``, ``softcap``, ``rope``), and
``swiglu`` rounds ``silu(g)`` to the working dtype before the product,
so bf16 results round where the reference's do.  Matmuls stay
``torch.matmul`` in the working dtype, through :func:`matmul`: one call
shape for every row count, so a row's bits do not depend on its batch
(serving), or one call over all rows (training).
:func:`cross_entropy_chunked` is the training loss's streamed
cross-entropy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class Param:
    shape: tuple
    logical: tuple               # logical axis name (or None) per dim
    dtype: Any = torch.bfloat16
    init: str = "normal"         # normal | zeros | ones | scaled
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def is_param(x) -> bool:
    return isinstance(x, Param)


def leaves(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested dict (a template's leaves are
    ``Param``s), in key order."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for key, sub in tree.items():
        yield from leaves(sub, prefix + (key,))


def _tree_map(f, template):
    if is_param(template):
        return f(template)
    return {k: _tree_map(f, v) for k, v in template.items()}


def initialize_(t: torch.Tensor, p: Param, generator: torch.Generator):
    """Fill ``t`` in place with ``p``'s initializer (the reference's:
    normal x scale, "scaled" = normal / sqrt(fan_in), zeros, ones), drawn
    in float32 from ``generator`` and cast to ``t``'s dtype."""
    if p.init == "zeros":
        return t.zero_()
    if p.init == "ones":
        return t.fill_(1)
    if p.init == "scaled":        # variance-scaled for output projections
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    else:
        std = p.scale
    draw = torch.randn(t.shape, generator=generator, dtype=torch.float32,
                       device=t.device)
    return t.copy_(draw.mul_(std))


def stack(template, n: int, axis_name: str | None = None):
    """Prepend a stacking (layer) axis to every Param in the template."""
    return _tree_map(
        lambda p: Param((n,) + p.shape, (axis_name,) + p.logical,
                        p.dtype, p.init, p.scale),
        template)


def param_count(template) -> int:
    return sum(math.prod(p.shape) for _, p in leaves(template))


# ------------------------------------------------------------------ primitives

#: rows of every matmul call :func:`matmul` makes
MATMUL_ROWS = 64


def matmul(x, w, train: bool = False):
    """``x @ w``, as fixed-shape ``(MATMUL_ROWS, K) @ (K, N)`` calls over
    the rows of ``x`` (the last call's rows padded with zeros); with
    ``train``, as one call over all rows.

    cuBLAS picks its kernel, and with it the order a row's products are
    summed in, by the row count: a decode step's row (M = slots) and the
    same row inside a prefill (M = batch x sequence) then round to bf16
    apart now and then, and over gemma2-9b's 42 layers those flips grow
    to 0.15 of the logits' std.  One call shape gives a row the same
    bits in any batch.

    Training has no decode step to match, and there the fixed calls
    would cost precision: autograd would sum a bf16 weight's gradient
    from one bf16 piece a call, where one product over all rows (the
    reference's einsum) rounds it once.
    """
    if train:
        return x @ w
    lead, k = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, k)
    n = rows.shape[0]
    if n % MATMUL_ROWS:
        rows = F.pad(rows, (0, 0, 0, MATMUL_ROWS - n % MATMUL_ROWS))
    if rows.shape[0] == MATMUL_ROWS:
        out = rows @ w
    else:
        out = torch.cat([t @ w for t in rows.split(MATMUL_ROWS)])
    return out[:n].reshape(*lead, w.shape[-1])


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def softcap(x, cap: float | None):
    if cap is None:
        return x
    xf = x.to(torch.float32)
    return (torch.tanh(xf / cap) * cap).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embedding. x: (..., S, H, D), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    freq = torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=x.device), exponent)
    ang = positions[..., :, None, None].to(torch.float32) * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down, train: bool = False):
    g = matmul(x, w_gate, train)
    u = matmul(x, w_up, train)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return matmul(h, w_down, train)


def gelu_mlp(x, w_in, w_out):
    h = matmul(x, w_in)
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return matmul(h, w_out)


def cross_entropy_chunked(logits_fn, x, labels, mask, chunk: int = 512,
                          final_cap: float | None = None):
    """Streamed mean cross-entropy over the positions ``mask`` weights.

    logits_fn: (B, c, D) -> (B, c, V).  The sequence runs in chunks of
    ``chunk`` (one chunk when ``chunk`` does not divide it), each
    recomputed in the backward pass (``checkpoint``), so only one
    chunk's (B, c, V) float32 logits is alive at a time.  Logits are
    softcapped, then taken to float32 for the ``logsumexp``; the gold
    logit is a gather, the same float32 value as the reference's one-hot
    sum (every other term is zero).  Sums run in float32, chunk by
    chunk, as the reference's scan.
    """
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s  # fallback: single chunk

    def body(xs, ls, ms):
        logits = softcap(logits_fn(xs), final_cap).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, ls[..., None].long())[..., 0]
        return ((lse - gold) * ms).sum()

    mask = mask.to(torch.float32)
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        ms = mask[:, i:i + chunk]
        loss_sum = loss_sum + checkpoint(body, x[:, i:i + chunk],
                                         labels[:, i:i + chunk], ms,
                                         use_reentrant=False)
        cnt = cnt + ms.sum()
    return loss_sum / torch.clamp(cnt, min=1.0)
