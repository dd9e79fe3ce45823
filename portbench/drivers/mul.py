"""``CompiledDesign.mul`` on device batches from the operand pool.

After each call, off the window's clock and on the benchmark's own side
stream, the driver takes an int64 fingerprint of every product and a
sample of rows drawn from the seed, and copies both to the host, waiting
there once, so that its device work never overlaps the program's.  A
call whose fingerprint and sampled rows equal an outcome its slot
already gave adds one to that outcome's count and keeps nothing; a call
that differs is kept as an outcome of its own.  A program that gives the
same products for the same operands (a sound one, the control, a
deterministic fault) keeps one outcome a slot, so what the driver holds
does not grow with the calls.  After the window, once the program is
freed, each kept outcome is held to the reference and counts for every
call that gave it: the same counts as holding each call to the
reference, since the calls of one outcome have the same fingerprint and
the same sampled rows."""
from __future__ import annotations

import dataclasses
from contextlib import nullcontext

import numpy as np
import torch

from portbench import generator, reference, roofline
from portbench.drivers._design import DesignDriver

#: outcomes past each slot's first whose sample is kept; past this many
#: (a program whose calls keep differing) a new outcome keeps its
#: fingerprint alone, and its sampled rows count as found by the
#: fingerprint alone
MAX_SAMPLES = 64


def fingerprint(out: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """One int64 of a ``(B, W)`` product batch, each limb times its own
    odd weight (sums wrap mod 2**64): any changed limb changes it, bar a
    chance of 2**-63."""
    return (out * weights).sum()


@dataclasses.dataclass
class Outcome:
    """The products one or more calls of a slot gave."""
    fp: int                          # their fingerprint
    sample: np.ndarray | None        # their sampled rows
    calls: int = 0


class Driver(DesignDriver):
    label = "mul"

    def __init__(self, config: dict, mix: dict, seed: int, device, mark):
        super().__init__(config, device, mark)
        spec = self.design.spec
        self.a, self.b = generator.operand_pool(mix, spec.bits_a,
                                                spec.bits_b, seed, device)
        self.slots, self.batch, la = self.a.shape
        lb = self.b.shape[2]
        gen = torch.Generator(device=device)
        gen.manual_seed(generator.unsigned_seed(seed + 1))
        self.rows = torch.randint(0, self.batch,
                                  (self.slots, int(mix["sample_rows"])),
                                  generator=gen, device=device)
        w_limb = torch.randint(0, 1 << 62, (la + lb,), generator=gen,
                               device=device) | 1
        w_row = torch.randint(0, 1 << 62, (self.batch,), generator=gen,
                              device=device) | 1
        self.weights = w_row[:, None] * w_limb       # odd, as both are
        cuda = device.type == "cuda"
        self.side = torch.cuda.Stream(device) if cuda else None
        # where each call's fingerprint and sample land on the host
        self.fp_host = torch.empty((), dtype=torch.int64, pin_memory=cuda)
        self.sample_host = torch.empty((self.rows.shape[1], la + lb),
                                       dtype=torch.int32, pin_memory=cuda)
        self.warmup_calls = int(mix["warmup_calls"])
        self.bound_s = roofline.round_bound_s(self.batch, la, lb)
        self.outcomes = [[] for _ in range(self.slots)]   # a slot's, first
        self.samples = 0             # samples kept past each slot's first
        self.n_calls = 0             # calls kept
        self.shapeless = 0           # calls whose output had another shape
        if self.side is not None:
            torch.cuda.synchronize(device)
        mark("inputs")

    def call(self, k: int):
        s = k % self.slots
        out = self.design.mul(self.a[s], self.b[s])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out, self.batch

    def keep(self, k: int, out) -> None:
        s = k % self.slots
        self.n_calls += 1
        if tuple(out.shape) != tuple(self.weights.shape):
            self.shapeless += 1      # every product missing
            return
        with torch.cuda.stream(self.side) if self.side else nullcontext():
            self.sample_host.copy_(out[self.rows[s]], non_blocking=True)
            self.fp_host.copy_(fingerprint(out, self.weights),
                               non_blocking=True)
        if self.side is not None:
            self.side.synchronize()
        fp, sample = int(self.fp_host), self.sample_host.numpy()
        seen = self.outcomes[s]
        found = next((o for o in seen if o.fp == fp and (
            o.sample is None or np.array_equal(o.sample, sample))), None)
        if found is None:            # another outcome than the slot's first
            keep = not seen or self.samples < MAX_SAMPLES
            self.samples += keep and bool(seen)
            found = Outcome(fp, sample.copy() if keep else None)
            seen.append(found)
        found.calls += 1

    def check(self) -> tuple:
        differs = wrong = 0
        for s, seen in enumerate(self.outcomes):
            if not seen:
                continue
            ref = reference.mul_limbs(self.a[s], self.b[s])
            want_fp = fingerprint(ref, self.weights).item()
            want = ref[self.rows[s]].cpu().numpy()
            del ref
            for o in seen:
                bad_rows = 0 if o.sample is None else \
                    int((o.sample != want).any(1).sum())
                if o.fp != want_fp:
                    differs += o.calls
                    bad_rows = max(bad_rows, 1)  # found by the fingerprint
                wrong += o.calls * bad_rows
        missing = self.shapeless * self.batch
        checks = {"calls_fingerprint_differs": (differs, 0),
                  "sampled_products_wrong": (wrong, 0),
                  "products_missing": (missing, 0)}
        return checks, self.batch * self.n_calls, wrong + missing
