"""Checksummed, async checkpointing, in the JAX package's on-disk layout.

Layout (one directory per step, atomically renamed into place), the
reference's ``checkpoint/manager.py`` byte for byte, so that each
package restores the other's checkpoints:

    <root>/step_000000420/
        manifest.json     step; each array's name, file, shape, dtype, CRC32
        arr_000000.npy    one file per leaf
        ...

* a tree is a nest of dicts; its leaves are flattened in the reference's
  order (dict keys sorted) and named by their ``/``-joined keys;
* bf16 is stored as its ``uint16`` bit view under the dtype name
  ``"bfloat16"`` (numpy has no bf16: the bits go through ``torch.int16``),
  and the CRC32 is taken over the saved bytes;
* writes go to ``<dir>.tmp`` then ``os.rename``: a crash mid-write never
  leaves a directory that looks valid; the oldest steps past ``keep``
  are removed;
* ``save_async`` copies the tensors to the host now (host tensors too,
  unless the caller passes ``copy=False``) and writes them on a worker
  thread; the next save (or ``wait``) joins it.

A model's parameters and AdamW moments go in the reference's stacked
shapes and names: ``models.api.stack_tree`` builds that tree from a
state dict, ``unstack_tree`` takes it back.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

#: dtype names the manifest may carry -> (torch dtype, numpy view saved)
_VIEWED = {"bfloat16": (torch.bfloat16, np.uint16)}


def _to_savable(t, snapshot: bool) -> tuple:
    """A leaf (tensor or array) -> (numpy array to save, dtype name); a
    ``snapshot`` never shares memory with the leaf."""
    if isinstance(t, torch.Tensor):
        on_host = t.device.type == "cpu"
        t = t.detach().cpu()
        if snapshot and on_host:
            t = t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(t, copy=snapshot)
    return arr, arr.dtype.name


def _from_saved(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _VIEWED:
        return torch.from_numpy(arr.view(np.int16)).view(
            _VIEWED[dtype_name][0])
    return torch.from_numpy(arr)


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).data) & 0xFFFFFFFF


def _flatten_with_names(tree, prefix=()):
    """``[(name, leaf)]`` of a nest of dicts, keys sorted at every level
    (``jax.tree_util``'s order), names ``/``-joined."""
    if not isinstance(tree, dict):
        return [("/".join(prefix), tree)]
    out = []
    for key in sorted(tree):
        out += _flatten_with_names(tree[key], prefix + (str(key),))
    return out


def _unflatten_like(tree, leaves):
    """``tree``'s structure with its leaves taken from ``leaves`` (an
    iterator, in :func:`_flatten_with_names` order)."""
    if not isinstance(tree, dict):
        return next(leaves)
    return {key: _unflatten_like(tree[key], leaves) for key in sorted(tree)}


@dataclasses.dataclass
class CheckpointManager:
    root: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree) -> str:
        return self._write(step, self._host(tree, False))

    def save_async(self, step: int, tree, copy: bool = True) -> None:
        """Device->host copy happens now; disk I/O on a worker thread.
        ``copy=False`` writes host leaves as they stand, for a caller
        that hands over fresh copies it will not change (the trainer's
        ``state_tree``)."""
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, self._host(tree, copy)),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def _host(tree, snapshot: bool) -> list:
        return [(name, *_to_savable(leaf, snapshot))
                for name, leaf in _flatten_with_names(tree)]

    def _write(self, step: int, host: list) -> str:
        final = os.path.join(self.root, f"step_{step:09d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "arrays": []}
        for i, (name, saved, dtype_name) in enumerate(host):
            fname = f"arr_{i:06d}.npy"
            np.save(os.path.join(tmp, fname), saved)
            manifest["arrays"].append({
                "name": name, "file": fname,
                "shape": list(saved.shape), "dtype": dtype_name,
                "crc32": _crc32(saved),
            })
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp") \
                    and os.path.exists(os.path.join(self.root, d,
                                                    "manifest.json")):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree, device=None, placements=None):
        """Restore into the structure of ``like_tree`` (leaves need only
        a ``shape``): CPU tensors in the saved dtypes, or on ``device``.
        Every array's CRC32 is checked before it is used.

        ``placements`` (the reference's ``shardings=``): a tree of the
        same structure whose leaves are ``(mesh, placements)`` or
        ``None``; such a leaf comes back a DTensor on that mesh, each
        rank keeping its chunk of the full array (on the mesh's device
        unless ``device`` says otherwise), whatever mesh wrote it."""
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        named = _flatten_with_names(like_tree)
        by_name = {a["name"]: a for a in manifest["arrays"]}
        missing = [n for n, _ in named if n not in by_name]
        if missing:
            raise ValueError(f"checkpoint missing arrays: {missing[:5]}")
        where = [None] * len(named) if placements is None else \
            [p for _, p in _flatten_with_names(placements)]
        out = []
        for (name, like), place in zip(named, where):
            meta = by_name[name]
            arr = np.load(os.path.join(d, meta["file"]))
            if _crc32(arr) != meta["crc32"]:
                raise IOError(f"CRC mismatch for {name} in {d}")
            t = _from_saved(arr, meta["dtype"])
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(
                    f"{name}: shape {tuple(t.shape)} != expected "
                    f"{tuple(like.shape)}")
            if place is not None:
                from ..models.base import distribute
                mesh, pls = place
                dev = device if device is not None else (
                    torch.device("cuda", torch.cuda.current_device())
                    if mesh.device_type == "cuda" else "cpu")
                t = distribute(t.to(dev), mesh, pls)
            elif device is not None:
                t = t.to(device)
            out.append(t)
        return _unflatten_like(like_tree, iter(out))
