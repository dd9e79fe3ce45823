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

On a mesh (DTensor parameters) the moments take their parameter's
placements, each gradient is redistributed to its parameter's
placements first (:func:`placed_like`: a ``Partial`` gradient's data
axis reduction happens there), the update runs on each rank's shards,
and :func:`sq_norms` gives every rank the same bits: each leaf's local
sum of squares from the ranks that hold a distinct shard of it, all
summed in one all-reduce over the mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake
import torch.distributed as dist
from torch.distributed.tensor import DTensor

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


def sq_norms(tree: dict) -> list:
    """Each leaf's float32 sum of squares (0-d tensors, in the tree's
    order).  DTensor leaves: the same bits on every rank of their mesh
    (one all-reduce of the ranks' local sums, a leaf's replicas but one
    contributing zero)."""
    leaves = list(tree.values())
    if not leaves or not isinstance(leaves[0], DTensor):
        return [torch.sum(torch.square(x.to(torch.float32)))
                for x in leaves]
    from ..models.base import mesh_group
    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    parts = []
    for x in leaves:
        local = torch.sum(torch.square(x.to_local().to(torch.float32)))
        owner = all(pl.is_shard() or c == 0
                    for pl, c in zip(x.placements, coord))
        parts.append(local if owner else torch.zeros_like(local))
    total = torch.stack(parts)
    if mesh.size() > 1:
        dist.all_reduce(total, group=mesh_group(mesh, mesh.mesh_dim_names))
    return list(total.unbind())


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(sq_norms(tree)))


def placed_like(params: dict, grads: dict) -> dict:
    """Each DTensor gradient at its parameter's placements (a
    ``Partial`` one reduced: the data-parallel reduction)."""
    out = {}
    for name, g in grads.items():
        p = params[name]
        if isinstance(g, DTensor) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        out[name] = g
    return out


def init_state(params: dict) -> dict:
    """``step`` (a 0-d int32 CPU tensor) and float32 moments ``m``, ``v``
    keyed as ``params``, on each parameter's device (a DTensor
    parameter's moments at its placements)."""
    def zeros():
        return {name: torch.zeros_like(p, dtype=torch.float32)
                if isinstance(p, DTensor) else
                torch.zeros(p.shape, dtype=torch.float32, device=p.device)
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
            t = self.host
            if device.type != "cpu":      # fake tensors (the dry run)
                if not is_fake(t):        # have no pages to pin
                    t = t.pin_memory()
                t = t.to(device, non_blocking=True)
            self.by_device[device] = t.unbind()
        return self.by_device[device]


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict,
                  cfg: AdamWConfig) -> dict:
    """One AdamW step: ``params`` and ``state`` are updated in place (the
    reference returns new trees).  Returns ``{"grad_norm", "lr"}``."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    grads = placed_like(params, grads)
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
        g, m, v = grads[name], state["m"][name], state["v"][name]
        if isinstance(p, DTensor):       # each rank its shards
            p, g, m, v = (t.to_local() for t in (p, g, m, v))
        g = g.to(torch.float32)
        if scale is not None:
            g = g * scale.to(g.device)
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        update = (m / bc1_d) / (torch.sqrt(v / bc2_d) + cfg.eps)
        pf = p.to(torch.float32)
        if cfg.weight_decay and decays(name):
            update = update + cfg.weight_decay * pf
        p.copy_((pf - lr_d * update).to(p.dtype))
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
