#!/usr/bin/env python3
"""Count the aten calls the host dispatches for one train step.

    PYTHONPATH=src python3 scripts/train_aten_calls.py

One step of ``runtime.make_train_step`` (forward, remat's second
forward, backward, AdamW over every parameter) on the CPU, counted with
a ``TorchDispatchMode`` (on the CPU the backward runs on the calling
thread, so its calls are counted too), at the structures of
``chip_smoke.py`` phase 10:

  (a) the 100m preset (qwen3 widths, 12 layers), 8 x 256 tokens;
  (b) gemma3-1b's structure at train_4k's 4,096 tokens: 26 layers of
      5 local + 1 global, 512-token query and key chunks (64 chunk pairs
      a layer), 8 cross-entropy chunks, at narrow widths and one
      sequence (the count depends on the layers and the chunks, not on
      the widths or the batch).

It prints the calls, how many of them return float64 tensors (the
attention's sums), and the parameters AdamW loops over.  Divided into a
step time measured on the card, the count gives the host's time a call
when the step is host-bound.
"""
from __future__ import annotations

import dataclasses
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, device_batch, make_source
from repro_torch.launch.train import PRESET_100M
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.runtime import make_train_step


class Count(TorchDispatchMode):
    """Counts aten calls, and those that return a float64 tensor."""

    def __init__(self):
        super().__init__()
        self.calls = self.float64 = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += 1
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.dtype == torch.float64:
            self.float64 += 1
        return out


def count(label, cfg, batch, seq):
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    step = make_train_step(model, AdamWConfig())
    state = init_state(dict(model.named_parameters()))
    src = make_source(DataConfig(cfg.vocab_size, seq, batch,
                                 source="pattern"), device="cpu")
    inputs = device_batch(src.batch_at(0), "cpu")
    counter = Count()
    t0 = time.perf_counter()
    with counter:
        step(state, inputs)
    print(f"{label}: {counter.calls:,} aten calls a step, "
          f"{counter.float64:,} of them float64; AdamW over "
          f"{len(state['m'])} parameters ({time.perf_counter() - t0:.1f} s "
          f"on the CPU)")


def main():
    count("(a) 100m preset, 8 x 256",
          dataclasses.replace(get_config("qwen3-32b"), **PRESET_100M), 8,
          256)
    count("(b) gemma3-1b structure, 1 x 4096 (narrow widths)",
          get_config("gemma3-1b", d_model=64, n_heads=4, n_kv_heads=1,
                     head_dim=32, d_ff=128, vocab_size=512), 1, 4096)


if __name__ == "__main__":
    main()
