"""Deterministic, shardable data pipeline.

Counterpart of the reference's ``data/pipeline.py``.  Three sources
behind one ``batch_at(step)`` interface, each returning numpy host
batches (``tokens``, ``labels``, ``mask``):

  * SyntheticLM   -- Philox counter-RNG token streams
    (:mod:`repro_torch.rng`): batch i of host h is a pure function of
    (seed, step, h), so a restart or re-shard never replays or skips
    data and needs no state.
  * PatternLM     -- a learnable stream, token_{t+1} = (token_t + 1) % V
    from a Philox start token per sequence.
  * BinTokenFile  -- a memory-mapped packed token file (.bin uint16/32)
    with deterministic Philox shuffling of window offsets.

The Philox draws run on ``device`` (the card unless the caller passes
``device="cpu"``); the batches they give are the same bits on either.
:func:`device_batch` puts a host batch on one device, or on a mesh as
DTensors sharded over its data axes.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from ..rng import random_tokens, random_u32


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"       # synthetic | pattern | binfile
    path: str = ""


def _host_batch(toks: np.ndarray, seq_len: int) -> dict:
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
        "mask": np.ones((toks.shape[0], seq_len), np.float32),
    }


class SyntheticLM:
    """Infinite deterministic LM batches; resume = set step."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1, device=None):
        if cfg.global_batch % host_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"divide over {host_count} hosts")
        self.cfg = cfg
        self.host_batch = cfg.global_batch // host_count
        self.host_index, self.host_count = host_index, host_count
        self.device = resolve_device(device)

    def _arange(self, start: int, n: int) -> torch.Tensor:
        return torch.arange(start, start + n, dtype=torch.int64,
                            device=self.device)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        n = self.host_batch * (cfg.seq_len + 1)
        base = (step * cfg.global_batch
                + self.host_index * self.host_batch) * (cfg.seq_len + 1)
        toks = random_tokens(cfg.seed, 1, self._arange(base, n),
                             cfg.vocab_size)
        return _host_batch(toks.cpu().numpy().reshape(
            self.host_batch, cfg.seq_len + 1), cfg.seq_len)


class PatternLM(SyntheticLM):
    """Learnable synthetic stream: token_{t+1} = (token_t + 1) % V.

    Deterministic (a Philox start token per sequence); a working model
    drives its loss to ~0 within tens of steps.
    """

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        base = step * cfg.global_batch + self.host_index * self.host_batch
        starts = random_u32(cfg.seed, 3, self._arange(
            base, self.host_batch))[:, 0].cpu().numpy() % cfg.vocab_size
        t = np.arange(cfg.seq_len + 1)
        toks = (starts[:, None] + t[None, :]) % cfg.vocab_size
        return _host_batch(toks, cfg.seq_len)


class BinTokenFile:
    """Memory-mapped token corpus with deterministic window shuffling."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1, dtype=np.uint16, device=None):
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq_len
        if self.n_windows < 1:
            raise ValueError("corpus shorter than one window")
        self.host_batch = cfg.global_batch // host_count
        self.host_index, self.host_count = host_index, host_count
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        idx0 = step * cfg.global_batch + self.host_index * self.host_batch
        sample_ids = torch.arange(idx0, idx0 + self.host_batch,
                                  dtype=torch.int64, device=self.device)
        # Philox-shuffled window assignment (deterministic, stateless)
        rnd = random_u32(cfg.seed, 2, sample_ids)[:, 0].cpu().numpy()
        windows = rnd % self.n_windows
        toks = np.stack([
            self.data[w * cfg.seq_len: w * cfg.seq_len + cfg.seq_len + 1]
            for w in windows])
        return _host_batch(toks, cfg.seq_len)


def make_source(cfg: DataConfig, host_index: int = 0, host_count: int = 1,
                device=None):
    if cfg.source == "synthetic":
        return SyntheticLM(cfg, host_index, host_count, device=device)
    if cfg.source == "pattern":
        return PatternLM(cfg, host_index, host_count, device=device)
    return BinTokenFile(cfg, host_index, host_count, device=device)


def device_batch(batch: dict, device=None, mesh=None,
                 local: bool = False) -> dict:
    """Host batch -> tensors on ``device`` (the card unless the caller
    passes ``device="cpu"``), or with a ``mesh`` DTensors on its device:
    a leaf of ndim >= 1 at ``P(data axes)`` (its rows split over the
    data axes, replicated over the model axis), a scalar at ``P()``.

    ``local``: each rank holds only its own rows already (a source made
    with ``host_index``/``host_count`` = its data coordinate and size),
    which become its shard with no copy between ranks."""
    if mesh is None:
        device = resolve_device(device)
        return {k: torch.as_tensor(v, device=device)
                for k, v in batch.items()}
    from ..launch.mesh import data_axes
    from ..models.base import P, distribute, placements
    device = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    axes = data_axes(mesh)
    shards = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                       for a in axes)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        if t.ndim and not local and t.shape[0] % shards:
            raise ValueError(f"batch leaf {k!r}: {t.shape[0]} rows do not "
                             f"split over {shards} data shards")
        pls = placements(P(axes) if t.ndim else P(), mesh)
        if local and t.ndim:
            out[k] = DTensor.from_local(t, mesh, pls, run_check=False)
        else:
            out[k] = distribute(t, mesh, pls)
    return out
