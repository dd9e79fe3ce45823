"""``CompiledDesign.serve`` on the pool of request traces; after the
window every response of every call is held to the reference."""
from __future__ import annotations

import numpy as np
import torch

from portbench import generator, reference
from portbench.drivers._design import DesignDriver


class Driver(DesignDriver):
    label = "worker"
    side = None
    bound_s = None

    def __init__(self, config: dict, mix: dict, seed: int, device, mark):
        super().__init__(config, device, mark)
        from repro_torch.serving import Request
        design = self.design
        spec = design.spec
        max_ct = max(cfg.ct for cfg in design.bank.instances)
        self.rows = generator.serve_traces(
            mix, spec.bits_a, spec.bits_b, float(design.plan.throughput),
            max_ct, seed)
        self.traces = [tuple(Request(rid=rid, arrival=t, deadline=d, a=a,
                                     b=b, bits_a=spec.bits_a,
                                     bits_b=spec.bits_b)
                             for rid, t, d, a, b in rows)
                       for rows in self.rows]
        self.replicas = int(mix["replicas"])
        self.warmup_calls = len(self.traces) * int(mix["warmup_passes"])
        self.blank = (-1,) * (design.la + design.lb)
        self.kept = []   # (trace, answered, products, late) a call
        mark("inputs")

    def call(self, k: int):
        _, responses = self.design.serve(self.traces[k % len(self.traces)],
                                         replicas=self.replicas,
                                         check=False)
        return responses, sum(r.admitted for r in responses.values())

    def keep(self, k: int, responses) -> None:
        """Keep each request's answer as arrays, so that the kept window
        holds no Python object a request (a growing heap would slow the
        collector inside the program's calls)."""
        t = k % len(self.traces)
        got = [responses.get(row[0]) for row in self.rows[t]]
        answered = [r is not None and r.admitted for r in got]
        products = np.array([r.product if ok else self.blank
                             for r, ok in zip(got, answered)], np.int64)
        late = sum(r.finish > row[2] for r, ok, row
                   in zip(got, answered, self.rows[t]) if ok)
        self.kept.append((t, np.array(answered), products, late))

    def check(self) -> tuple:
        want = []
        for rows in self.rows:
            a = torch.tensor([r[3] for r in rows], dtype=torch.int32)
            b = torch.tensor([r[4] for r in rows], dtype=torch.int32)
            want.append(reference.mul_limbs(a, b).numpy().astype(np.int64))
        unanswered = wrong = late = 0
        for t, answered, products, n_late in self.kept:
            unanswered += int((~answered).sum())
            wrong += int(((products != want[t]).any(1) & answered).sum())
            late += n_late
        checks = {"requests_unanswered": (unanswered, 0),
                  "products_wrong": (wrong, 0),
                  "deadlines_missed": (late, 0)}
        attempted = sum(len(answered) for _, answered, _, _ in self.kept)
        return checks, attempted, unanswered + wrong + late
