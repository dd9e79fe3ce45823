"""``CompiledDesign.mul`` on device batches from the operand pool.

After each call, off the window's clock, the benchmark takes on its own
side stream a fingerprint of every product and a sample of rows drawn
from the seed, and waits for them, so that its device work never
overlaps the program's.  After the window both are held to the
reference's."""
from __future__ import annotations

from contextlib import nullcontext

import torch

from portbench import generator, reference, roofline
from portbench.drivers._design import DesignDriver


def fingerprint(out: torch.Tensor, w_limb: torch.Tensor,
                w_row: torch.Tensor) -> torch.Tensor:
    """One int64 of a ``(B, W)`` product batch (sums wrap mod 2**64):
    any changed limb changes it, bar a chance of 2**-63."""
    return ((out.to(torch.int64) * w_limb).sum(1) * w_row).sum()


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
        self.w_limb = torch.randint(0, 1 << 62, (la + lb,), generator=gen,
                                    device=device) | 1
        self.w_row = torch.randint(0, 1 << 62, (self.batch,), generator=gen,
                                   device=device) | 1
        self.side = torch.cuda.Stream(device) if device.type == "cuda" \
            else None
        self.warmup_calls = int(mix["warmup_calls"])
        self.bound_s = roofline.round_bound_s(self.batch, la, lb)
        self.kept = []               # (slot, fingerprint, sample) a call
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
        if tuple(out.shape) != (self.batch, self.w_limb.numel()):
            self.kept.append((s, None, None))     # every product missing
            return
        with torch.cuda.stream(self.side) if self.side else nullcontext():
            self.kept.append((s, fingerprint(out, self.w_limb, self.w_row),
                              out[self.rows[s]]))
        if self.side is not None:
            self.side.synchronize()

    def check(self) -> tuple:
        want = {}
        for s in sorted({s for s, _, _ in self.kept}):
            ref = reference.mul_limbs(self.a[s], self.b[s])
            want[s] = (fingerprint(ref, self.w_limb, self.w_row).item(),
                       ref[self.rows[s]])
            del ref
        differs = wrong = missing = 0
        for s, fp, sample in self.kept:
            if fp is None:
                missing += self.batch
                continue
            bad_rows = int((sample != want[s][1]).any(1).sum())
            wrong += bad_rows
            if fp.item() != want[s][0]:
                differs += 1
                wrong += bad_rows == 0   # found by the fingerprint alone
        checks = {"calls_fingerprint_differs": (differs, 0),
                  "sampled_products_wrong": (wrong, 0),
                  "products_missing": (missing, 0)}
        return checks, self.batch * len(self.kept), wrong + missing
