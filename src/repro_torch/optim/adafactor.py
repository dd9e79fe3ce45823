"""Adafactor (Shazeer & Stern 2018): factored second moments.

The JAX package's ``optim/adafactor.py`` on dicts of tensors keyed by
name, updated in place.  Row and column EMAs of the squared gradient
stand for the second moment of a matrix (O(n + m) state instead of
O(nm)); vectors keep the full second moment.  Updates are clipped by
their RMS; momentum is omitted (the beta1 = 0 variant, as T5).

Unlike AdamW it is not elementwise over a layer stack: the reference
decides factoring on a leaf's *stacked* shape (a stacked norm of shape
(4, 128) is factored, an unstacked (128,) never is) and clips by the
RMS over the whole stacked leaf.  So the port updates one reference leaf
at a time: ``leaves`` (``models.api.stacked_layout`` of the model's
config) names the parameters each leaf stacks; they are stacked, updated
as the reference updates the leaf, and written back.  The state keeps
the reference's stacked shapes, keyed by the leaf's ``/``-joined path.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .adamw import StepConstants


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-2
    decay: float = 0.8            # t^-decay second-moment EMA schedule
    eps1: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    min_dim_factored: int = 2     # factor matrices with both dims >= this


def _factored(shape, cfg: AdafactorConfig) -> bool:
    return len(shape) >= 2 and shape[-1] >= cfg.min_dim_factored \
        and shape[-2] >= cfg.min_dim_factored


def _leaves(params: dict, leaves) -> dict:
    """``{key: (stacked shape, [(name, index)])}``: ``leaves`` (path
    tuples joined by ``/``), or each parameter its own leaf."""
    if leaves is None:
        return {name: (tuple(p.shape), [(name, ())])
                for name, p in params.items()}
    return {"/".join(path) if isinstance(path, tuple) else path: spec
            for path, spec in leaves.items()}


def _stacked(tensors: dict, shape, members):
    """The members of one leaf as one tensor of its stacked shape."""
    first = tensors[members[0][0]]
    if members == [(members[0][0], ())]:
        return first
    out = torch.empty(shape, dtype=first.dtype, device=first.device)
    for name, idx in members:
        out[idx] = tensors[name]
    return out


def init_state(params: dict, cfg: AdafactorConfig = AdafactorConfig(),
               leaves=None) -> dict:
    """``step`` (a 0-d int32 CPU tensor) and ``v``: each leaf's factored
    ``{"vr", "vc"}`` or full ``{"v"}`` float32 state, stacked shapes."""
    state = {}
    for key, (shape, members) in _leaves(params, leaves).items():
        device = params[members[0][0]].device

        def zeros(shp):
            return torch.zeros(shp, dtype=torch.float32, device=device)
        if _factored(shape, cfg):
            state[key] = {"vr": zeros(shape[:-1]),
                          "vc": zeros(shape[:-2] + shape[-1:])}
        else:
            state[key] = {"v": zeros(shape)}
    return {"step": torch.zeros((), dtype=torch.int32), "v": state}


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict,
                  cfg: AdafactorConfig, leaves=None) -> dict:
    """One Adafactor step, ``params`` and ``state`` in place (the
    reference returns new trees).  Returns ``{"beta2"}``."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    beta2 = 1.0 - t ** (-cfg.decay)
    consts = StepConstants(beta2[None])
    for key, (shape, members) in _leaves(params, leaves).items():
        p = _stacked(params, shape, members)
        g = _stacked(grads, shape, members).to(torch.float32)
        v = state["v"][key]
        dev = g.device
        b2, = consts.on(dev)

        def f32(x):
            return torch.full((), x, dtype=torch.float32, device=dev)
        g2 = g * g + cfg.eps1
        if _factored(shape, cfg):
            vr = b2 * v["vr"] + (1 - b2) * g2.mean(dim=-1)
            vc = b2 * v["vc"] + (1 - b2) * g2.mean(dim=-2)
            # rank-1 reconstruction of 1/sqrt(v)
            r = vr / torch.maximum(vr.mean(dim=-1, keepdim=True),
                                   f32(cfg.eps1))
            upd = g / (torch.sqrt(r)[..., None]
                       * torch.sqrt(vc)[..., None, :] + cfg.eps1)
            v["vr"].copy_(vr)
            v["vc"].copy_(vc)
        else:
            vf = b2 * v["v"] + (1 - b2) * g2
            upd = g / (torch.sqrt(vf) + cfg.eps1)
            v["v"].copy_(vf)
        # update clipping by the RMS over the whole stacked leaf
        rms = torch.sqrt(torch.mean(upd * upd))
        upd = upd / torch.maximum(f32(1.0), rms / f32(cfg.clip_threshold))
        pf = p.to(torch.float32)
        if cfg.weight_decay:
            pf = pf - cfg.lr * cfg.weight_decay * pf
        new = (pf - cfg.lr * upd).to(p.dtype)
        for name, idx in members:
            params[name].copy_(new[idx])
    state["step"] = step
    return {"beta2": beta2}


def state_bytes(params: dict, leaves=None) -> tuple:
    """(adam_bytes, adafactor_bytes) of a parameter dict, Adafactor's
    from the leaves' stacked shapes -- the scale claim."""
    adam = sum(2 * 4 * p.numel() for p in params.values())
    cfg = AdafactorConfig()
    af = 0
    for shape, _ in _leaves(params, leaves).values():
        if _factored(shape, cfg):
            af += 4 * (math.prod(shape[:-1])
                       + math.prod(shape[:-2] + shape[-1:]))
        else:
            af += 4 * math.prod(shape)
    return adam, af
