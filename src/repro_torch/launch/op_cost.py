"""Per-rank cost of one call, counted op by op: the stand-in for the JAX
package's ``launch/hlo_cost.py``.

The reference reads the cost of a compiled step from its optimized HLO
text (dot flops and collectives, times the trip counts of its while
loops).  PyTorch has no compiled artifact to read, so :func:`analyze`
runs the function under one ``TorchDispatchMode`` and counts the aten
ops as they dispatch, on real tensors or on ``FakeTensorMode``'s (the
dry run's: nothing is allocated or computed).  It returns the
reference's keys:

  * ``dot_flops`` / ``conv_flops`` / ``flops``: 2 x result elements x
    contracted size of each matrix product and convolution, as
    ``hlo_cost`` counts a dot;
  * ``bytes``: the bytes each op reads and writes (its tensor inputs and
    outputs; views, metadata and allocation ops move none).  This is the
    unfused traffic, an upper bound on HBM bytes: a fused kernel reads
    its intermediates from registers.  It stands in for XLA's ``bytes
    accessed``.  ``bytes_by_op`` splits it by aten op (``"mm"``, ...);
  * ``collectives``: every functional (``_c10d_functional``) and raw
    (``c10d``) collective with its result bytes, group size and group
    ranks (``records``), summed per type with ring link bytes
    (:func:`repro_torch.launch.roofline.collective_link_bytes`), and
    ``link_bytes``, their total;
  * ``unknown_trip_whiles``: 0.  A Python loop over layers or chunks
    dispatches its ops once per iteration, so trip counts are in the
    counts already.

The counts are one rank's.  A DTensor op is seen first with its global
shapes; the mode lets DTensor run it (``NotImplemented``, as torch's
``CommDebugMode`` does) and counts what DTensor dispatches below: the
redistributions' collectives and the op on each rank's local shards.
DTensor's sharding propagation, which runs an op on fake tensors of the
global shapes to learn its output's, is not counted.  Ops inside
``local_map`` are local already.

``peak_bytes`` is the most bytes that the tensors the counted ops made
held at once (each counted until its Python object dies; views and
in-place results add nothing), a per-rank live-memory peak of the
call's own tensors for the dry run (its arguments not included).

Uses private PyTorch pieces (checked on torch 2.11 and 2.13):
``torch.distributed.tensor._sharding_prop.ShardingPropagator`` and
``torch.distributed.distributed_c10d._resolve_process_group``.
"""
from __future__ import annotations

import collections
import contextlib
import math
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .roofline import collective_link_bytes

#: matrix products -> the argument whose last dim they contract
_MATMULS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1, "dot": 0, "mv": 0,
            "addmv": 1, "_int_mm": 0, "_scaled_mm": 0}
#: collective ops (functional and c10d) -> their type
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "all_gather_into_tensor_coalesced":
    "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast_": "collective-permute", "broadcast": "collective-permute",
}
_FREE = {"empty", "empty_strided", "new_empty", "new_empty_strided",
         "empty_like", "detach", "lift_fresh", "alias",
         "wait_tensor", "_local_scalar_dense", "set_", "resize_"}

_IN_PROPAGATION = [0]


@contextlib.contextmanager
def _no_count_in_propagation():
    """Mark DTensor's sharding propagation (its fake run of an op at the
    global shapes) so the counter skips the ops it dispatches."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, *args, **kwargs):
        _IN_PROPAGATION[0] += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _IN_PROPAGATION[0] -= 1
    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _group_of(func, args) -> dist.ProcessGroup | None:
    """The process group of a collective's arguments: a ``c10d`` op
    takes the group itself, a functional one its name."""
    for a in tree_leaves(args):
        if isinstance(a, dist.ProcessGroup):
            return a
    name = args[-1]
    if isinstance(name, str):
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        return _resolve_process_group(name)
    return None


class OpCounter(TorchDispatchMode):
    """Counts flops, bytes, collectives and live bytes of the ops that
    dispatch while it is active (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.conv_flops = 0.0
        self.bytes = 0.0
        self.bytes_by_op = collections.Counter()
        self.n_ops = 0
        self.records = []
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakValueDictionary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor desugars; counted below
        out = func(*args, **kwargs)
        if not _IN_PROPAGATION[0]:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d") and name in _COLLECTIVE_OPS:
            self._collective(func, name, args, out)
            return
        if ns == "prim" or name in _FREE or func.is_view:
            return
        self.n_ops += 1
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.bytes += moved
        self.bytes_by_op[name] += moved
        if name in _MATMULS:
            a = args[_MATMULS[name]]
            self.dot_flops += 2.0 * outs[0].numel() * a.shape[-1]
        elif name in ("convolution", "_convolution", "conv2d", "conv1d"):
            w = args[1]
            self.conv_flops += 2.0 * outs[0].numel() * math.prod(
                w.shape[1:])
        for t in outs:
            self._track(t)

    def _collective(self, func, name, args, out):
        group = _group_of(func, args)
        ranks = dist.get_process_group_ranks(group) if group else [0]
        if name in ("allreduce_", "allreduce_coalesced_", "broadcast_"):
            res = args[0]                 # in place: a list of tensors
        elif name in ("_allgather_base_", "_reduce_scatter_base_",
                      "allgather_", "reduce_scatter_", "alltoall_base_",
                      "alltoall_", "allgather_into_tensor_coalesced_"):
            res = args[0]                 # the output buffer(s)
        else:
            res = out
        self.records.append({
            "op": _COLLECTIVE_OPS[name],
            "result_bytes": sum(map(_nbytes, tree_leaves(res))),
            "group_size": len(ranks), "ranks": list(ranks)})
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)

    def _track(self, t):
        """Add ``t``'s bytes to the live bytes until it is freed."""
        if id(t) in self._seen:           # an in-place op's output
            return
        n = _nbytes(t)
        self._seen[id(t)] = t
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n):
        self.live -= n

    def result(self) -> dict:
        colls = collective_link_bytes(self.records)
        return {
            "dot_flops": self.dot_flops,
            "conv_flops": self.conv_flops,
            "flops": self.dot_flops + self.conv_flops,
            "bytes": self.bytes,
            "bytes_by_op": dict(self.bytes_by_op),
            "collectives": colls,
            "link_bytes": sum(c["link_bytes"] for c in colls.values()),
            "collective_s": sum(c["seconds"] for c in colls.values()),
            "records": self.records,
            "unknown_trip_whiles": 0,
            "n_ops": self.n_ops,
            "peak_bytes": self.peak,
        }


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter` and
    return its counts (the module's docstring lists the keys); the
    call's return value is under ``"out"``."""
    with _no_count_in_propagation(), OpCounter() as counter:
        out = fn(*args, **kwargs)
    res = counter.result()
    res["out"] = out
    return res
