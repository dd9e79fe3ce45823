"""Batched serving loop: continuous-batching-lite over prefill/decode.

A slot manager keeps ``--slots`` concurrent sequences in flight; requests
(prompts) are admitted into free slots in arrival order, prefilled, then
decoded one token per engine step across the whole batch.  Finished
sequences free their slot immediately (continuous batching), and bursts
of same-length arrivals share ONE batched prefill call.  The engine
keeps the model's caches (``Model.init_cache``: one KV cache a layer, or
a hybrid's per application KV and SSM state) for all slots and updates
them in place.  It feeds ``{"tokens"}`` only, so it serves the dense,
moe, ssm and hybrid families; the encoder has no decode step and the
VLM needs image embeddings, which ``main`` refuses, as the reference's
engine cannot serve them either.

Admissions are recorded as an *arrival trace* (``arrival_trace()``):
the engine cycle each request entered the system, nondecreasing, which
feeds the bank layer's streaming scheduler.  ``--mcim-design`` names a
registered ``repro_torch.designs`` point (default the paper's TP=3.5
bank); after serving, the trace is replayed through that compiled design
so the run reports how the silicon bank would have dispatched the same
request stream.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --smoke --device cpu --requests 12 --slots 4 --max-new 16
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from ..configs import ARCH_NAMES, get_config
from ..device import resolve_device
from ..models import build_model
from ..models.base import shard_slice
from ..rng import random_tokens

#: the families whose model ``ServeEngine`` drives (token prompts)
SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


class ServeEngine:
    """Fixed-slot continuous batching around prefill + decode_step.

    With a ``mesh`` (the model distributed on it, ``Model.distribute_``)
    the slots' caches are DTensors at ``cache_specs``' placements and
    ``cur``/``pos`` at ``batch_spec``'s; a burst's prefill is placed by
    its own batch (replicated over the data axes when it does not divide
    them) and each rank copies the rows of its own slots."""

    def __init__(self, model, slots: int, prompt_len: int, s_cap: int,
                 mesh=None):
        self.model, self.mesh = model, mesh
        self.slots = slots
        self.prompt_len = prompt_len
        self.s_cap = s_cap
        self.caches = None
        self.pos = self._slot_vector()
        self.cur = self._slot_vector()
        self.live = np.zeros((slots,), bool)
        self.outputs = {}          # request_id -> generated tokens
        self.request_of_slot = [-1] * slots
        self.cycle = 0             # engine steps taken (decode cycles)
        self._arrivals = []        # (request_id, admission cycle)
        self._completions = {}     # request_id -> completion cycle

    def _slot_vector(self):
        """(slots,) int64 zeros; on the mesh at ``batch_spec``'s
        placements."""
        if self.mesh is None:
            return torch.zeros((self.slots,), dtype=torch.int64,
                               device=self.model.device)
        from torch.distributed.tensor import zeros
        from ..models.base import placements
        from .sharding import batch_spec
        return zeros((self.slots,), dtype=torch.int64,
                     device_mesh=self.mesh, placements=placements(
                         batch_spec(self.mesh, 1, self.slots), self.mesh))

    def _local_slots(self, t, slots):
        """(positions in the local shard of DTensor ``t``, rows of the
        burst) of the ``slots`` whose dim-0 entry this rank holds."""
        held = shard_slice(t, 0)
        pairs = [(s - held.start, r) for r, s in enumerate(slots)
                 if held.start <= s < held.stop]
        return [p for p, _ in pairs], [r for _, r in pairs]

    def _put(self, full, batched, slots):
        """Rows of ``batched`` (a burst's tensor) into the DTensor ``full``
        at ``slots`` (dim 0), in place: each rank copies the rows of its
        own slots from the burst brought to ``full``'s placements, whole
        over the batch."""
        if isinstance(batched, DTensor):
            batched = batched.redistribute(self.mesh, tuple(
                Replicate() if pl.is_shard(0) else pl
                for pl in full.placements)).to_local()
        idx, rows = self._local_slots(full, slots)
        if idx:
            full = full.to_local()
            dev = full.device
            full[torch.tensor(idx, device=dev)] = batched[
                torch.tensor(rows, device=dev)].to(full.dtype)

    def admit(self, request_id: int, prompt: np.ndarray) -> None:
        self.admit_many([(request_id, prompt)])

    def admit_many(self, requests) -> None:
        """Admit ``[(request_id, prompt)]`` into free slots.

        Requests with equal prompt lengths prefill as ONE batched model
        call: with >= 2 slots free a burst of arrivals costs a single
        prefill instead of one per request (ragged lengths fall back to
        one call per length group).
        """
        if not requests:
            return
        free = [int(s) for s in np.flatnonzero(~self.live)]
        if len(requests) > len(free):
            raise ValueError(
                f"admitting {len(requests)} requests with {len(free)} "
                f"free slots")
        for rid, _ in requests:    # admission cycle, in arrival order;
            # recorded only once capacity is confirmed, so a rejected
            # burst that is retried later cannot corrupt the trace
            self._arrivals.append((rid, self.cycle))
        by_len = {}
        for rid, prompt in requests:
            by_len.setdefault(prompt.shape[0], []).append((rid, prompt))
        for plen, group in by_len.items():
            slots = [free.pop(0) for _ in group]
            tokens = torch.as_tensor(np.stack([p for _, p in group]))
            caches, logits = self.model.prefill({"tokens": tokens},
                                                s_cap=self.s_cap,
                                                mesh=self.mesh)
            toks = torch.argmax(logits, -1)
            if self.mesh is not None:
                toks = toks.full_tensor()
            if self.caches is None:
                self.caches = self.model.init_cache(self.slots, self.s_cap,
                                                    self.mesh)
            if self.mesh is None:
                idx = torch.tensor(slots, device=self.model.device)
                for full, batched in zip(self.caches, caches):
                    for name, buf in full.items():
                        buf[idx] = batched[name]
                self.pos[idx] = plen
                self.cur[idx] = toks
            else:
                for full, batched in zip(self.caches, caches):
                    for name, buf in full.items():
                        self._put(buf, batched[name], slots)
                self._put(self.pos, torch.full_like(toks, plen), slots)
                self._put(self.cur, toks, slots)
            for slot, (rid, _), tok in zip(slots, group, toks.tolist()):
                self.live[slot] = True
                self.request_of_slot[slot] = rid
                self.outputs[rid] = [tok]

    def arrival_trace(self) -> tuple:
        """Admission cycles of every admitted request, in arrival order.

        Nondecreasing by construction (``cycle`` only grows), so the
        trace feeds straight into the bank layer's streaming scheduler,
        e.g. ``designs.generate(name).replay(trace)``.
        """
        return tuple(cycle for _, cycle in self._arrivals)

    def step(self) -> None:
        """One decode step over every slot, finished ones included (their
        tokens are dropped)."""
        self.cycle += 1
        self.caches, logits = self.model.decode_step(
            self.caches, self.cur, self.pos, mesh=self.mesh)
        nxt = torch.argmax(logits, -1)
        self.pos = self.pos + 1
        self.cur = nxt
        if self.mesh is not None:
            nxt = nxt.full_tensor()
        for slot, tok in enumerate(nxt.tolist()):
            if self.live[slot]:
                self.outputs[self.request_of_slot[slot]].append(tok)

    def completion_trace(self) -> tuple:
        """Completion cycles aligned with ``arrival_trace()`` (same
        request order), so per-request end-to-end latency is just the
        elementwise difference.  Requests still in flight report -1."""
        return tuple(self._completions.get(rid, -1)
                     for rid, _ in self._arrivals)

    def latency_trace(self) -> tuple:
        """Per-request end-to-end engine cycles (admission to finish),
        in arrival order; in-flight requests are excluded."""
        return tuple(done - arr for (_, arr), done
                     in zip(self._arrivals, self.completion_trace())
                     if done >= 0)

    def finish(self, slot: int) -> None:
        rid = self.request_of_slot[slot]
        if rid >= 0:
            self._completions[rid] = self.cycle
        self.live[slot] = False
        self.request_of_slot[slot] = -1


def serve(eng: ServeEngine, prompts, max_new: int) -> None:
    """Drive ``eng`` until every prompt has ``max_new`` engine steps:
    each step first admits all pending prompts that fit (one batched
    prefill), then decodes one token for every slot."""
    next_req = done = 0
    new_counts = {}
    while done < len(prompts):
        n_free = int(eng.slots - eng.live.sum())
        pending = []
        while next_req < len(prompts) and len(pending) < n_free:
            pending.append((next_req, prompts[next_req]))
            new_counts[next_req] = 0
            next_req += 1
        eng.admit_many(pending)
        eng.step()
        for slot in range(eng.slots):
            rid = eng.request_of_slot[slot]
            if rid >= 0:
                new_counts[rid] += 1
                if new_counts[rid] >= max_new:
                    eng.finish(slot)
                    done += 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--mcim-design", default="tp3p5_w32",
                    help="registered repro_torch.designs name to replay "
                         "the admission trace through ('none' to skip)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family not in SERVED_FAMILIES:
        needs = {"encoder": "frames and has no decode step",
                 "vlm": "image embeddings beside its tokens"}
        raise ValueError(
            f"--arch {args.arch}: the {cfg.family} family takes "
            f"{needs[cfg.family]}; the engine serves token prompts "
            f"({', '.join(SERVED_FAMILIES)})")
    device = resolve_device(args.device)
    model = build_model(cfg, device)
    t0 = time.perf_counter()
    model.init(torch.Generator(device=device).manual_seed(0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"[serve] {args.arch}: {model.param_count():,} parameters, "
          f"seeded init in {time.perf_counter() - t0:.3f}s")
    s_cap = args.prompt_len + args.max_new + 8
    eng = ServeEngine(model, args.slots, args.prompt_len, s_cap)

    prompts = [random_tokens(7, r, torch.arange(args.prompt_len),
                             cfg.vocab_size).numpy()
               for r in range(args.requests)]
    t0 = time.perf_counter()
    serve(eng, prompts, args.max_new)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(o) for o in eng.outputs.values())
    print(f"[serve] {args.requests} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens/dt:.1f} tok/s) on {device}")
    if args.mcim_design != "none":
        # end-to-end wiring: the real admission trace drives the bank
        # layer's streaming scheduler through the designs facade
        from .. import designs
        from ..core.bank import histogram_percentile, latency_histogram
        design = designs.generate(args.mcim_design, device=device)
        rep = design.replay(eng.arrival_trace())
        print(f"[serve] mcim replay of {len(eng.arrival_trace())} "
              f"admissions over {eng.cycle} engine cycles through "
              f"{design.plan.describe()}: makespan {rep.cycles} bank "
              f"cycles, {rep.measured_throughput} ops/cycle "
              f"(scheduler={rep.scheduler})")
        # end-to-end latency, both sides of the wiring: what the engine
        # measured (admission -> finish) and what the bank's replay
        # attributes to dispatch (admission -> retire)
        eng_hist = latency_histogram(eng.latency_trace())
        print(f"[serve] engine latency p50/p99 = "
              f"{histogram_percentile(eng_hist, 0.50)}/"
              f"{histogram_percentile(eng_hist, 0.99)} engine cycles; "
              f"bank replay latency p50/p99 = "
              f"{rep.latency_p50}/{rep.latency_p99} bank cycles")
        eng.replay = rep
    return eng


if __name__ == "__main__":
    main()
