"""Fault-tolerant training loop, as the JAX package's
``runtime/trainer.py``, on one device.

  * the train step: autograd over ``Model.train_loss``, microbatch
    gradient accumulation (optionally *exact* through
    ``exact.exact_tree_sum``: bit-identical for any microbatch order),
    AdamW applied in place;
  * non-finite guard: a step whose loss or squared gradient norm is not
    finite keeps the parameters and moments and counts the event; the
    optimizer's step still advances, as the reference's;
  * periodic async checkpoints in the reference's layout and names (the
    layers stacked back: ``models.api.stack_tree``), resume from the
    latest; SIGTERM requests a final checkpoint;
  * straggler watchdog: per-step wall-time EWMA, steps slower than
    ``straggler_factor`` x the EWMA are logged with their index;
  * :func:`maybe_init_distributed`, the multi-process bootstrap hook.

The train step syncs with the device once (the loss and the squared
gradient norm read together); the loop's batch, drawn on the host or
copied back from the device and then sent to it, adds its own copies.
The mesh path (``make_train_step(mesh=...)``, the
parameter specs) is ROADMAP queue 1 item 2: training across processes
raises ``NotImplementedError`` until then.
"""
from __future__ import annotations

import dataclasses
import math
import os
import signal
import tempfile
import time

import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..data.pipeline import device_batch
from ..exact import exact_tree_sum
from ..models import api
from ..models.api import Model
from ..optim import AdamWConfig, apply_updates, init_state, schedule_lr


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    microbatches: int = 1
    exact_accum: bool = False        # MCIM fixed-point accumulation
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    keep_checkpoints: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0


def maybe_init_distributed() -> None:
    """Multi-process bootstrap from torch's own environment variables
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as
    ``torchrun`` sets them); a no-op in a single process."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 \
            and not dist.is_initialized():
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo")


def _div(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t / n`` by a tensor on ``t``'s device (CUDA divides by a Python
    scalar as a multiply by its reciprocal)."""
    return t / torch.full((), n, dtype=t.dtype, device=t.device)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatches: int = 1, exact_accum: bool = False):
    """``step(opt_state, batch) -> stats``: one optimizer step on
    ``model``'s parameters (gradients turned on here) and ``opt_state``
    (AdamW's, keyed by parameter name), both in place.  ``stats``:
    ``loss``, ``finite``, ``grad_norm``, ``lr`` (host numbers)."""
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    names, params = list(named), list(named.values())

    def value_and_grad(batch):
        loss = model.train_loss(batch)
        return loss.detach(), torch.autograd.grad(loss, params)

    def step_fn(opt_state: dict, batch: dict) -> dict:
        if microbatches == 1:
            loss, grads = value_and_grad(batch)
        else:
            rows = next(iter(batch.values())).shape[0] // microbatches
            pairs = [value_and_grad({k: v[i * rows:(i + 1) * rows]
                                     for k, v in batch.items()})
                     for i in range(microbatches)]
            gs = [g for _, g in pairs]
            if exact_accum:
                grads = [_div(g, microbatches) for g in exact_tree_sum(gs)]
            else:
                grads = [_div(sum(col), microbatches) for col in zip(*gs)]
            loss = _div(sum(l for l, _ in pairs), microbatches)

        gnorm_sq = sum(torch.sum(torch.square(g.to(torch.float32)))
                       for g in grads)
        loss_v, gsq = torch.stack([loss.to(torch.float32),
                                   gnorm_sq]).tolist()    # the one sync
        finite = math.isfinite(loss_v) and math.isfinite(gsq)
        if finite:
            lr = apply_updates(named, dict(zip(names, grads)), opt_state,
                               opt_cfg)["lr"]
        else:        # keep params and moments, advance the step anyway
            opt_state["step"] = opt_state["step"] + 1
            lr = schedule_lr(opt_cfg, opt_state["step"])
        return {"loss": loss_v, "finite": finite,
                "grad_norm": math.sqrt(gsq), "lr": float(lr)}

    return step_fn


@dataclasses.dataclass
class TrainResult:
    losses: list
    skipped_steps: int
    straggler_steps: list
    final_step: int
    step_seconds: list               # wall time of each step run


def state_tree(model: Model, opt_state: dict) -> dict:
    """``{"params", "opt": {"step", "m", "v"}}`` in the reference's
    stacked shapes and names, on the CPU: what a checkpoint holds.  The
    leaves are fresh copies but ``step``, which the optimizer replaces
    and never changes in place."""
    cfg = model.cfg
    return {"params": api.stack_tree(cfg, dict(model.named_parameters())),
            "opt": {"step": opt_state["step"],
                    "m": api.stack_tree(cfg, opt_state["m"]),
                    "v": api.stack_tree(cfg, opt_state["v"])}}


def _like_tree(cfg) -> dict:
    """:func:`state_tree`'s structure, leaves shaped (meta tensors)."""
    params = {}
    for path, (shape, _) in api.stacked_layout(cfg).items():
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.empty(shape, device="meta")
    return {"params": params, "opt": {"step": torch.empty((), device="meta"),
                                      "m": params, "v": params}}


@torch.no_grad()
def load_state(model: Model, opt_state: dict, tree: dict) -> None:
    """Copy a restored :func:`state_tree` into ``model`` and
    ``opt_state``; a leaf whose dtype is not the target's raises."""
    cfg = model.cfg
    targets = [(dict(model.named_parameters()), tree["params"]),
               (opt_state["m"], tree["opt"]["m"]),
               (opt_state["v"], tree["opt"]["v"])]
    for dst, src in targets:
        for name, t in api.unstack_tree(cfg, src).items():
            if t.dtype != dst[name].dtype:
                raise TypeError(f"checkpoint {name}: {t.dtype}, expected "
                                f"{dst[name].dtype}")
            dst[name].copy_(t)
    opt_state["step"] = tree["opt"]["step"].to(torch.int32)


def train(model: Model, source, opt_cfg: AdamWConfig,
          tcfg: TrainerConfig, params: dict | None = None,
          resume: bool = True, seed: int = 0) -> TrainResult:
    """Train ``model`` for ``tcfg.steps`` steps of ``source.batch_at``;
    ``params`` (a state dict) or a seeded init gives the start, unless a
    checkpoint in ``tcfg.checkpoint_dir`` resumes it."""
    maybe_init_distributed()
    if dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "training across processes needs the mesh path (ROADMAP "
            "queue 1 item 2)")
    ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
    if params is None:
        model.init(torch.Generator(device=model.device).manual_seed(seed))
    else:
        model.load_state_dict(params)
    step_fn = make_train_step(model, opt_cfg, tcfg.microbatches,
                              tcfg.exact_accum)
    opt_state = init_state(dict(model.named_parameters()))
    start_step = 0

    if resume and ckpt.latest_step() is not None:
        s = ckpt.latest_step()
        load_state(model, opt_state, ckpt.restore(s, _like_tree(model.cfg)))
        start_step = s
        print(f"[trainer] resumed from step {s}")

    stop = {"now": False}

    def _sigterm(signum, frame):   # preemption notice
        stop["now"] = True
    old_handler = signal.signal(signal.SIGTERM, _sigterm)

    losses, stragglers, seconds = [], [], []
    skipped = 0
    ewma = None
    step = start_step - 1
    try:
        for step in range(start_step, tcfg.steps):
            t0 = time.perf_counter()
            batch = device_batch(source.batch_at(step), model.device)
            stats = step_fn(opt_state, batch)
            loss = stats["loss"]
            if not stats["finite"]:
                skipped += 1
            losses.append(loss)
            dt = time.perf_counter() - t0
            seconds.append(dt)
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > tcfg.straggler_factor * ewma and step > start_step + 2:
                stragglers.append(step)
                print(f"[trainer] straggler step {step}: "
                      f"{dt:.2f}s vs EWMA {ewma:.2f}s")
            if tcfg.log_every and step % tcfg.log_every == 0:
                print(f"[trainer] step {step} loss {loss:.4f} "
                      f"gnorm {stats['grad_norm']:.3f} {dt:.2f}s")
            if tcfg.checkpoint_every and \
                    (step + 1) % tcfg.checkpoint_every == 0:
                ckpt.save_async(step + 1, state_tree(model, opt_state),
                                copy=False)
            if stop["now"]:
                print(f"[trainer] SIGTERM at step {step}; checkpointing")
                break
        ckpt.wait()
        ckpt.save(step + 1, state_tree(model, opt_state))
    finally:
        signal.signal(signal.SIGTERM, old_handler)
    return TrainResult(losses=losses, skipped_steps=skipped,
                       straggler_steps=stragglers, final_step=step + 1,
                       step_seconds=seconds)
