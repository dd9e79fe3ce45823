"""AdamW with decoupled weight decay, global-norm clipping, schedules.

The JAX package's ``optim/adamw.py`` on dicts of tensors keyed by name
(a model's ``named_parameters``), updated in place.  Moments are float32
whatever the parameter's dtype; a parameter updates in its own dtype.
The arithmetic is the reference's, operation for operation, in float32:
the learning rate and the bias corrections come from the step on the
CPU and go to each device once a step, without a sync, and every
division is by a tensor on the operands' device (CUDA divides by a
Python scalar as a multiply by its reciprocal).  AdamW is
elementwise, so updating a model's unstacked layers changes only the
order in which :func:`global_norm` sums the leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

#: substrings of a leaf's name that exempt it from weight decay: norms,
#: biases, the SSM's scalar parameters, the encoder's mask embedding
NO_DECAY = ("norm", "bias", "A_log", "D", "dt_bias", "mask_embed")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"        # cosine | constant | linear
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor): a 0-d
    float32 CPU tensor, the reference's float32 arithmetic."""
    step = _f32(step).cpu()
    warm = torch.minimum(step / _f32(max(cfg.warmup_steps, 1)), _f32(1.0))
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clip((step - cfg.warmup_steps) / _f32(
            max(cfg.total_steps - cfg.warmup_steps, 1)), 0, 1)
        if cfg.schedule == "linear":
            decay = 1.0 - (1.0 - cfg.min_lr_ratio) * frac
        else:                        # cosine
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
                * 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def decays(name: str) -> bool:
    """Weight decay applies to ``name`` (a state-dict name, or the
    reference's ``/``-joined leaf path: the same set either way)."""
    return not any(t in name for t in NO_DECAY)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


def init_state(params: dict) -> dict:
    """``step`` (a 0-d int32 CPU tensor) and float32 moments ``m``, ``v``
    keyed as ``params``, on each parameter's device."""
    def zeros():
        return {name: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                for name, p in params.items()}
    return {"step": torch.zeros((), dtype=torch.int32), "m": zeros(),
            "v": zeros()}


class StepConstants:
    """A step's host constants, copied to each device once.  The copy
    to a card goes from pinned memory without blocking: a blocking
    host-to-device copy waits for the card's stream to drain."""

    def __init__(self, host: torch.Tensor):
        self.host = host
        self.by_device = {}

    def on(self, device: torch.device) -> tuple:
        if device not in self.by_device:
            t = self.host if device.type == "cpu" else \
                self.host.pin_memory().to(device, non_blocking=True)
            self.by_device[device] = t.unbind()
        return self.by_device[device]


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict,
                  cfg: AdamWConfig) -> dict:
    """One AdamW step: ``params`` and ``state`` are updated in place (the
    reference returns new trees).  Returns ``{"grad_norm", "lr"}``."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.minimum(torch.ones_like(gnorm),
                              torch.full_like(gnorm, cfg.clip_norm)
                              / (gnorm + 1e-9))
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** _f32(step)
    bc2 = 1 - b2 ** _f32(step)
    consts = StepConstants(torch.stack([lr, bc1, bc2]))
    for name, p in params.items():
        lr_d, bc1_d, bc2_d = consts.on(p.device)
        g = grads[name].to(torch.float32)
        if scale is not None:
            g = g * scale.to(g.device)
        m, v = state["m"][name], state["v"][name]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        update = (m / bc1_d) / (torch.sqrt(v / bc2_d) + cfg.eps)
        pf = p.to(torch.float32)
        if cfg.weight_decay and decays(name):
            update = update + cfg.weight_decay * pf
        p.copy_((pf - lr_d * update).to(p.dtype))
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
