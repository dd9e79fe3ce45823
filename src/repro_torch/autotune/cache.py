"""JSON file cache for autotuner fronts: spec-space hash -> ParetoFront.

A sweep's result is fully determined by (the specs searched, the cost
models' calibration, the enumeration vocabulary), so the cache key
hashes exactly those.  Any change to the power model (MODEL_VERSION),
the candidate vocabulary, or a spec field produces a new key -- stale
fronts are never served, and a cached re-run of the same spec space
performs zero re-scores (asserted by tests and the bench).

The cache directory resolves, in order: an explicit ``cache_dir``
argument, ``$REPRO_TORCH_AUTOTUNE_CACHE``,
``~/.cache/repro_torch_autotune`` -- the port's own directory and
variable, never the reference package's, so a front the reference wrote
is never served here (the key alone would collide: both hash the same
payload).
"""
from __future__ import annotations

import hashlib
import json
import os

from repro_torch.core.power_model import MODEL_VERSION
from .pareto import ParetoFront

#: bump when enumeration/scoring semantics change
AUTOTUNE_VERSION = "autotune-1"


def cache_dir_path(cache_dir: str | None = None) -> str:
    if cache_dir is not None:
        return cache_dir
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "repro_torch_autotune")


def space_key(specs) -> str:
    """Deterministic hash of a spec space (order-insensitive)."""
    payload = json.dumps({
        "autotune": AUTOTUNE_VERSION,
        "power_model": MODEL_VERSION,
        "specs": sorted(s.to_json() for s in specs),
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


def _path(cache_dir: str | None, key: str) -> str:
    return os.path.join(cache_dir_path(cache_dir), f"front_{key}.json")


def load(key: str, cache_dir: str | None = None) -> ParetoFront | None:
    """The cached front for ``key``, or None (corrupt files = miss)."""
    path = _path(cache_dir, key)
    try:
        with open(path) as f:
            front = ParetoFront.from_json(f.read(), from_cache=True)
    except (OSError, ValueError, KeyError):
        return None
    if front.space_key != key:          # stale/foreign file: ignore
        return None
    return front


def store(key: str, front: ParetoFront,
          cache_dir: str | None = None) -> str:
    """Persist ``front`` under ``key``; returns the file path."""
    root = cache_dir_path(cache_dir)
    os.makedirs(root, exist_ok=True)
    path = _path(cache_dir, key)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(front.to_json())
    os.replace(tmp, path)               # atomic: concurrent sweeps are safe
    return path
