"""Mamba2 blocks via the SSD (state-space duality) chunked algorithm.

The JAX package's ``models/ssm.py`` in plain PyTorch (Dao & Gu 2024,
arXiv:2405.21060): within chunks of length Q the recurrence is a masked
quadratic form; across chunks a loop carries the (H, N, P) state.  All
decay and cumsum math runs in float32, and every exponent that reaches a
result is <= 0.

The reference's rounding points stay: the intra-chunk product takes the
weights rounded to bf16 against bf16 inputs and keeps the float32 sum
(``preferred_element_type``), so here both operands are rounded and
multiplied in float32.  Prefill convolves with a loop of float32 tap
adds; decode takes one float32 contraction over the window.

Decode is the O(1) recurrent step on a carried (state, conv window)
cache, written in place.

Every mode runs on a mesh too (DTensors): the projection is replicated
over the model axis, each rank runs the SSD (or the decode step) for its
heads (the reference's constraint of ``xh`` to heads on "model"), and
the gated output's matmul is reduced over the model axis.  Serving
writes DTensor caches at ``cache_specs``' placements: each rank its
rows, conv channels (CH -> "model") and heads' state (H -> "model").
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from . import base
from .base import Param
from .transformer import TensorSpec, constrain_act
from ..configs.base import ArchConfig


def ssm_template(cfg: ArchConfig) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    conv_ch = di + 2 * n
    proj_out = 2 * di + 2 * n + h          # z, x, B, C, dt
    return {
        "norm": Param((d,), (None,), init="zeros"),
        "in_proj": Param((d, proj_out), ("fsdp", "model")),
        "conv_w": Param((cfg.ssm_conv_width, conv_ch), (None, "model"),
                        scale=0.1),
        "conv_b": Param((conv_ch,), ("model",), init="zeros"),
        "dt_bias": Param((h,), (None,), dtype=torch.float32, init="zeros"),
        "A_log": Param((h,), (None,), dtype=torch.float32, init="zeros"),
        "D": Param((h,), (None,), dtype=torch.float32, init="ones"),
        "gate_norm": Param((di,), (None,), init="zeros"),
        "out_proj": Param((di, d), ("model", "fsdp"), init="scaled"),
    }


def ssm_cache_spec(cfg: ArchConfig, batch: int) -> dict:
    di, n, h, pdim = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                      cfg.ssm_head_dim)
    conv_ch = di + 2 * n
    return {
        "conv": TensorSpec((batch, cfg.ssm_conv_width - 1, conv_ch),
                           torch.bfloat16),
        "state": TensorSpec((batch, h, n, pdim), torch.float32),
    }


def _split_proj(zxbcdt, cfg: ArchConfig):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * n]
    dt_raw = zxbcdt[..., -h:]
    return z, xbc, dt_raw


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(xbc, w, b):
    """Depthwise causal conv via shifted adds. xbc: (B, S, CH)."""
    kw = w.shape[0]
    pad = F.pad(xbc, (0, 0, kw - 1, 0))
    s = xbc.shape[1]
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for k in range(kw):
        out = out + pad[:, k:k + s].to(torch.float32) \
            * w[k].to(torch.float32)
    out = out + b.to(torch.float32)
    return F.silu(out).to(xbc.dtype)


def _gated_out(p, y, z, u, cfg: ArchConfig, train: bool = False,
              mesh=None):
    y = base.rms_norm(y * F.silu(z.to(torch.float32)).to(y.dtype),
                      p.gate_norm, cfg.norm_eps)
    return constrain_act(u + base.matmul(y, p.out_proj, train), mesh)


def ssm_apply(p, u, cfg: ArchConfig, mode: str, cache=None, mesh=None):
    """Returns ``u + mamba2(u)``; with a ``cache`` (prefill or decode) it
    is written in place: the last ``kw - 1`` pre-conv rows and the final
    state.  u: (B, S, D); a prefill needs S >= kw - 1.  Mode "train" is
    the prefill's forward with no cache and one matmul call a
    projection; a ``mesh`` (DTensor ``u``) is the training path's."""
    if mode == "decode":
        if mesh is not None:
            return _ssm_decode_mesh(p, u, cfg, cache, mesh)
        return _ssm_decode(p, u, cfg, cache)
    train = mode == "train"
    if mesh is not None:
        return _ssm_mesh(p, u, cfg, mesh, train, cache)
    xn = base.rms_norm(u, p.norm, cfg.norm_eps)
    zxbcdt = base.matmul(xn, p.in_proj, train)
    y, xbc_pre, state = _ssd(zxbcdt, p.conv_w, p.conv_b, p.dt_bias,
                             p.A_log, p.D, cfg)
    out = _gated_out(p, y.to(u.dtype), zxbcdt[..., :cfg.d_inner], u, cfg,
                     train)
    if cache is not None:
        _write_prefill_cache(cache, xbc_pre, state, cfg)
    return out


def _write_prefill_cache(cache, xbc_pre, state, cfg: ArchConfig,
                         channels: slice = slice(None)):
    """The last ``kw - 1`` pre-conv rows (their ``channels``) and the
    final state into ``cache``, in place."""
    kw = cfg.ssm_conv_width
    s_orig = xbc_pre.shape[1]
    if s_orig < kw - 1:
        raise ValueError(f"a prefill needs at least {kw - 1} tokens "
                         f"(the conv window), got {s_orig}")
    cache["conv"].copy_(xbc_pre[:, s_orig - (kw - 1):s_orig, channels])
    cache["state"].copy_(state)


def _whole(mesh, *ts) -> list:
    """Parameters replicated on every rank (gathered)."""
    everywhere = tuple(Replicate() for _ in base.mesh_names(mesh))
    return [t.redistribute(mesh, everywhere) for t in ts]


def _mesh_heads(cfg: ArchConfig, mesh):
    """(this rank's SSM heads, their model-axis placement): split over
    the model axis when it divides them (the reference's ``xh`` on
    ("model") heads, and its state cache's H -> model)."""
    h, m = cfg.n_ssm_heads, base.axis_size(mesh, "model")
    if m > 1 and h % m == 0:
        r = mesh.get_local_rank("model")
        return slice(r * h // m, (r + 1) * h // m), Shard(2)
    return slice(None), Replicate()


def _ssm_mesh(p, u, cfg: ArchConfig, mesh, train: bool = True,
              cache=None):
    """:func:`ssm_apply`'s full-sequence forward on DTensors (training,
    or a prefill filling a DTensor ``cache`` at ``cache_specs``'
    placements: each rank its rows, conv channels and heads)."""
    xn = base.rms_norm(u, p.norm, cfg.norm_eps)
    zxbcdt = constrain_act(base.matmul(xn, p.in_proj, train), mesh)
    prm = _whole(mesh, base.gathered(p.conv_w), base.gathered(p.conv_b),
                 p.dt_bias, p.A_log, p.D)
    heads, model_pl = _mesh_heads(cfg, mesh)
    held = () if cache is None else (cache["conv"], cache["state"])
    channels = None if cache is None else \
        base.shard_slice(cache["conv"], 2)

    def fn(zl, *ps):
        y, xbc_pre, state = _ssd(zl, *ps[:5], cfg, heads)
        if ps[5:]:
            _write_prefill_cache(dict(zip(("conv", "state"), ps[5:])),
                                 xbc_pre, state, cfg, channels)
        return y.to(zl.dtype)
    y = base.local_map(fn, mesh, (zxbcdt, *prm, *held),
                       base.batch_placed(zxbcdt, mesh, model_pl).placements)
    y = constrain_act(y, mesh)
    return _gated_out(p, y, zxbcdt[..., :cfg.d_inner], u, cfg, train, mesh)


def _ssd(zxbcdt, conv_w, conv_b, dt_bias, A_log, D, cfg: ArchConfig,
         heads: slice = slice(None)):
    """The SSD of the in-projection's output (B, S, 2 di + 2 N + H) over
    ``heads`` (all by default) -> (float32 y (B, S, heads x P), the
    pre-conv rows, the final state)."""
    b, s_orig, _ = zxbcdt.shape
    di, n, h, pdim = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                      cfg.ssm_head_dim)
    q = cfg.ssm_chunk
    f32 = torch.float32
    _, xbc_pre, dt_raw = _split_proj(zxbcdt, cfg)
    xbc = _causal_conv(xbc_pre, conv_w, conv_b)
    dt = _softplus(dt_raw.to(f32) + dt_bias)

    # pad to a chunk multiple; padded steps get dt=0 => identity decay
    # and zero state contribution (exact for any length)
    s = -(-s_orig // q) * q
    if s != s_orig:
        xbc = F.pad(xbc, (0, 0, 0, s - s_orig))
        dt = F.pad(dt, (0, 0, 0, s - s_orig))
    nc = s // q

    xc = xbc[..., :di].reshape(b, nc, q, h, pdim)[..., heads, :]
    bc = xbc[..., di:di + n].reshape(b, nc, q, n).to(f32)      # G = 1
    cc = xbc[..., di + n:].reshape(b, nc, q, n).to(f32)
    dtc = dt.reshape(b, nc, q, h)[..., heads]
    a = -torch.exp(A_log[heads])                                # (H,) < 0
    h = dtc.shape[-1]
    cum = torch.cumsum(dtc * a, dim=2)                          # (B,nc,q,H)

    # ---- intra-chunk (quadratic) ----
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)                # (B,nc,q,q)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (B,nc,i,j,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=zxbcdt.device))
    # above the diagonal seg >= 0 and its exp may overflow: masked before
    # the exp (-inf -> 0, the same values as masking after it), its
    # gradient is 0, not 0 * inf = nan as in the reference once a chunk's
    # dt * |A| sums past ~88
    lmat = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                 -torch.inf))
    w = cb[..., None] * lmat * dtc[:, :, None, :, :]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp",
                          w.to(xc.dtype).to(f32), xc.to(f32))

    # ---- chunk states + inter-chunk recurrence ----
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)              # (B,nc,q,H)
    states = torch.einsum("bcln,bclhp->bchnp", bc,
                          (decay_out * dtc)[..., None] * xc.to(f32))
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # (B,nc,H)
    state = torch.zeros((b, h, n, pdim), dtype=f32, device=zxbcdt.device)
    prev = []                  # the state before each chunk
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    states_prev = torch.stack(prev, dim=1)                      # (B,nc,H,N,P)

    y_off = torch.einsum("bcin,bchnp->bcihp", cc, states_prev) \
        * torch.exp(cum)[..., None]
    y = (y_diag + y_off) + D[heads][None, None, None, :, None] \
        * xc.to(f32)
    return y.reshape(b, s, h * pdim)[:, :s_orig], xbc_pre, state


def _ssm_step(zxbcdt, conv, state, conv_w, conv_b, dt_bias, A_log, D,
              cfg: ArchConfig, heads: slice = slice(None)):
    """The recurrent step of the in-projection's output (B, 1, ...) over
    ``heads`` from the conv window ``conv`` (B, kw - 1, CH) and
    ``heads``' ``state`` -> (y (B, 1, heads x P) in zxbcdt's dtype, the
    next window, the next state)."""
    b = zxbcdt.shape[0]
    di, n, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    f32 = torch.float32
    _, xbc_pre, dt_raw = _split_proj(zxbcdt, cfg)

    window = torch.cat([conv.to(xbc_pre.dtype), xbc_pre], dim=1)
    xbc = torch.einsum("bkc,kc->bc", window.to(f32), conv_w.to(f32)) \
        + conv_b.to(f32)
    xbc = F.silu(xbc).to(zxbcdt.dtype)                          # (B, CH)

    xh = xbc[:, :di].reshape(b, -1, pdim)[:, heads].to(f32)
    bm = xbc[:, di:di + n].to(f32)
    cm = xbc[:, di + n:].to(f32)
    dt = _softplus(dt_raw[:, 0].to(f32) + dt_bias)[:, heads]
    da = torch.exp(dt * -torch.exp(A_log[heads]))               # (B, H)

    state = state * da[..., None, None] \
        + bm[:, None, :, None] * (dt[..., None] * xh)[:, :, None, :]
    y = torch.einsum("bn,bhnp->bhp", cm, state) \
        + D[heads][None, :, None] * xh
    return y.reshape(b, 1, -1).to(zxbcdt.dtype), window[:, 1:], state


def _ssm_decode(p, u, cfg: ArchConfig, cache):
    """One-token recurrent step. u: (B, 1, D); ``cache`` in place."""
    xn = base.rms_norm(u, p.norm, cfg.norm_eps)
    zxbcdt = base.matmul(xn, p.in_proj)
    y, window, state = _ssm_step(zxbcdt, cache["conv"], cache["state"],
                                 p.conv_w, p.conv_b, p.dt_bias, p.A_log,
                                 p.D, cfg)
    cache["conv"].copy_(window)
    cache["state"].copy_(state)
    return _gated_out(p, y.to(u.dtype), zxbcdt[..., :cfg.d_inner], u, cfg)


def _ssm_decode_mesh(p, u, cfg: ArchConfig, cache, mesh):
    """:func:`_ssm_decode` on DTensors against a DTensor ``cache`` at
    ``cache_specs``' placements: every rank convolves the whole window
    (the conv cache gathered over the model axis), then steps its own
    heads' state and writes its own channels and heads."""
    xn = base.rms_norm(u, p.norm, cfg.norm_eps)
    zxbcdt = constrain_act(base.matmul(xn, p.in_proj), mesh)
    conv = cache["conv"]
    conv_all = conv.redistribute(mesh, base.on_model(
        conv.placements, mesh, Replicate()))
    prm = _whole(mesh, base.gathered(p.conv_w), base.gathered(p.conv_b),
                 p.dt_bias, p.A_log, p.D)
    heads, model_pl = _mesh_heads(cfg, mesh)
    channels = base.shard_slice(conv, 2)

    def fn(zl, window, conv_l, state_l, *ps):
        y, nxt, state = _ssm_step(zl, window, state_l, *ps, cfg, heads)
        conv_l.copy_(nxt[..., channels])
        state_l.copy_(state)
        return y
    y = base.local_map(fn, mesh, (zxbcdt, conv_all, conv, cache["state"],
                                  *prm),
                       base.on_model(zxbcdt.placements, mesh, model_pl))
    y = constrain_act(y, mesh)
    return _gated_out(p, y.to(u.dtype), zxbcdt[..., :cfg.d_inner], u, cfg,
                      mesh=mesh)
