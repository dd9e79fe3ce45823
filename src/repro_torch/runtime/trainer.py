"""Fault-tolerant training loop, as the JAX package's
``runtime/trainer.py``, on one device or on a ``DeviceMesh``.

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

With ``mesh=`` (a ``DeviceMesh`` from ``launch.mesh``) the model is
distributed on it (``Model.distribute_``: the reference's parameter
specs), the AdamW moments take the parameters' placements, each batch
comes as DTensors split over the data axes (``device_batch``; a source
made per data shard hands over its own rows), and the gradients are
reduced to the parameters' placements before the update.  The loss and
the squared gradient norm are the same bits on every rank, so every
rank's non-finite guard decides alike.  A checkpoint gathers each leaf
on every rank (``full_tensor``) and rank 0 writes it; a restore
distributes the full leaves again.
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
from torch.distributed.tensor import DTensor

from ..checkpoint import CheckpointManager
from ..data.pipeline import device_batch
from ..exact import exact_tree_sum
from ..models import api
from ..models.api import Model
from ..models.base import constrain, local_chunk
from ..optim import AdamWConfig, apply_updates, init_state, schedule_lr
from ..optim.adamw import placed_like, sq_norms


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


def maybe_init_distributed(device=None) -> None:
    """Multi-process bootstrap from torch's own environment variables
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets them); a no-op in a single
    process and where a process group exists.

    Each rank takes the card ``LOCAL_RANK`` as its current device and
    joins an NCCL world (one card a rank: NCCL refuses two ranks on one
    card), so that ``resolve_device(None)`` and ``device_batch`` place
    its model and batches there.  A rank with no card of its own raises.
    With a CPU ``device`` the world is gloo's."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return
    if device is not None and torch.device(device).type == "cpu":
        dist.init_process_group("gloo")
        return
    local = int(os.environ.get("LOCAL_RANK", "0"))
    cards = torch.cuda.device_count()
    if local >= cards:
        raise RuntimeError(
            f"local rank {local} has no card of its own ({cards} on this "
            f"host): an NCCL world takes one card a rank (pass a CPU "
            f"device for a gloo world)")
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", device_id=torch.device("cuda", local))


def _div(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t / n`` by a tensor on ``t``'s device (CUDA divides by a Python
    scalar as a multiply by its reciprocal); a DTensor's shards."""
    if isinstance(t, DTensor):
        return DTensor.from_local(_div(t.to_local(), n), t.device_mesh,
                                  t.placements, run_check=False)
    return t / torch.full((), n, dtype=t.dtype, device=t.device)


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered on every rank (a collective); else ``t``."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _accumulate(gs: list, exact: bool, mesh=None) -> list:
    """The mean of microbatch gradient lists ``gs``; ``exact`` through
    ``exact_tree_sum`` (bit-identical for any order).  On a mesh the
    gradients are DTensors at their parameters' placements and the exact
    sum runs on each rank's shards: it is elementwise, so the bits are
    the whole tensors' sum's."""
    n = len(gs)
    if exact and mesh is not None:
        local = exact_tree_sum([[g.to_local() for g in row] for row in gs])
        return [_div(DTensor.from_local(t, g.device_mesh, g.placements,
                                        run_check=False), n)
                for g, t in zip(gs[0], local)]
    if exact:
        return [_div(g, n) for g in exact_tree_sum(gs)]
    return [_div(sum(col), n) for col in zip(*gs)]


def make_train_step(model: Model, opt_cfg: AdamWConfig, mesh=None,
                    microbatches: int = 1, exact_accum: bool = False):
    """``step(opt_state, batch) -> stats``: one optimizer step on
    ``model``'s parameters (gradients turned on here) and ``opt_state``
    (AdamW's, keyed by parameter name), both in place.  ``stats``:
    ``loss``, ``finite``, ``grad_norm``, ``lr`` (host numbers).

    With a ``mesh`` the model is distributed on it here unless it
    already is (``opt_state`` must be made after, from its parameters);
    the batch is a ``device_batch(..., mesh=mesh)``.

    ``step.gradients(batch)`` is the step's device work alone (loss,
    gradients, squared norm); ``step`` adds the one host sync, the
    non-finite guard and the AdamW update."""
    if mesh is not None and model.mesh is None:
        model.distribute_(mesh)
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    names, params = list(named), list(named.values())

    def value_and_grad(batch):
        loss = model.train_loss(batch, mesh)
        grads = torch.autograd.grad(loss, params)
        if mesh is not None:          # the data-parallel reduction
            grads = list(placed_like(named, dict(zip(names,
                                                     grads))).values())
        return loss.detach(), grads

    def gradients(batch: dict) -> tuple:
        """The step's device work before the update: (loss, gradients in
        parameter order, their float32 squared norm), no host sync (the
        dry run traces it, then ``optim.apply_updates``)."""
        if microbatches == 1:
            loss, grads = value_and_grad(batch)
        else:
            rows = next(iter(batch.values())).shape[0] // microbatches

            def micro(v, i):   # the global batch's rows, as the reference
                v = v[i * rows:(i + 1) * rows]
                return v if mesh is None else constrain(
                    v, mesh, "batch", *([None] * (v.ndim - 1)))
            pairs = [value_and_grad({k: micro(v, i)
                                     for k, v in batch.items()})
                     for i in range(microbatches)]
            grads = _accumulate([g for _, g in pairs], exact_accum, mesh)
            loss = _div(sum(l for l, _ in pairs), microbatches)
        return loss, grads, sum(sq_norms(dict(zip(names, grads))))

    def step_fn(opt_state: dict, batch: dict) -> dict:
        loss, grads, gnorm_sq = gradients(batch)
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

    step_fn.gradients = gradients
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

    def stacked(tree):        # a mesh's leaves gathered one at a time
        return api.stack_tree(cfg, {n: _full(t) for n, t in tree.items()})
    return {"params": stacked(dict(model.named_parameters())),
            "opt": {"step": opt_state["step"],
                    "m": stacked(opt_state["m"]),
                    "v": stacked(opt_state["v"])}}


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
            d = dst[name]
            if isinstance(d, DTensor):      # this rank's chunk
                d.to_local().copy_(local_chunk(t, d.device_mesh,
                                               d.placements))
            else:
                d.copy_(t)
    opt_state["step"] = tree["opt"]["step"].to(torch.int32)


def train(model: Model, source, opt_cfg: AdamWConfig,
          tcfg: TrainerConfig, params: dict | None = None,
          resume: bool = True, seed: int = 0, mesh=None) -> TrainResult:
    """Train ``model`` for ``tcfg.steps`` steps of ``source.batch_at``;
    ``params`` (a state dict) or a seeded init gives the start, unless a
    checkpoint in ``tcfg.checkpoint_dir`` resumes it.  On a ``mesh`` a
    source made for one data shard (``host_count`` > 1) hands each rank
    its own rows; rank 0 alone prints and writes checkpoints."""
    maybe_init_distributed(model.device)
    if mesh is None and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise ValueError("a world of several ranks trains on a mesh "
                         "(train(..., mesh=launch.mesh.make_host_mesh()))")
    lead = not dist.is_initialized() or dist.get_rank() == 0
    ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
    if params is None:
        model.init(torch.Generator(device=model.device).manual_seed(seed))
    else:
        model.load_state_dict(params)
    step_fn = make_train_step(model, opt_cfg, mesh, tcfg.microbatches,
                              tcfg.exact_accum)
    opt_state = init_state(dict(model.named_parameters()))
    local_rows = mesh is not None and getattr(source, "host_count", 1) > 1

    def save(step, now):
        tree = state_tree(model, opt_state)      # every rank gathers
        if not lead:
            return
        if now:
            ckpt.save(step, tree)
        else:
            ckpt.save_async(step, tree, copy=False)
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
            batch = source.batch_at(step)
            batch = device_batch(batch, model.device) if mesh is None \
                else device_batch(batch, mesh=mesh, local=local_rows)
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
                if lead:
                    print(f"[trainer] straggler step {step}: "
                          f"{dt:.2f}s vs EWMA {ewma:.2f}s")
            if lead and tcfg.log_every and step % tcfg.log_every == 0:
                print(f"[trainer] step {step} loss {loss:.4f} "
                      f"gnorm {stats['grad_norm']:.3f} {dt:.2f}s")
            if tcfg.checkpoint_every and \
                    (step + 1) % tcfg.checkpoint_every == 0:
                save(step + 1, now=False)
            if stop["now"]:
                print(f"[trainer] SIGTERM at step {step}; checkpointing")
                break
        ckpt.wait()
        save(step + 1, now=True)
    finally:
        signal.signal(signal.SIGTERM, old_handler)
    return TrainResult(losses=losses, skipped_steps=skipped,
                       straggler_steps=stragglers, final_step=step + 1,
                       step_seconds=seconds)
