"""Int8 gradient compression with error feedback, in PyTorch.

Counterpart of the reference's ``optim/compress.py``: gradients are
quantized to int8 with per-row scales before the data-parallel
reduction, and the quantization residual is carried in an
error-feedback buffer so the compression bias vanishes over steps
(Karimireddy et al. 2019).  The quantize/dequantize pair reuses
:func:`repro_torch.kernels.int8_matmul.quantize_rows`.

Trees are any nesting of dicts, lists and tuples of tensors
(``torch.utils._pytree``).  :func:`compressed_psum` is the collective
form across data-parallel replicas: ``torch.distributed.all_reduce``
over a process group stands for the reference's ``pmax``/``psum`` over a
mesh axis.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..kernels.int8_matmul import quantize_rows


def init_error(params):
    """A float32 zero error buffer shaped like each leaf of ``params``."""
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def _q(x: torch.Tensor):
    flat = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x.reshape(1, -1)
    q, s = quantize_rows(flat, axis=1)
    return q.reshape(x.shape), s


def _dq(q: torch.Tensor, s: torch.Tensor, shape) -> torch.Tensor:
    last = shape[-1] if len(shape) > 1 else q.numel()
    flat = q.reshape(-1, last).to(torch.float32)
    return (flat * s.reshape(-1, 1)).reshape(shape)


def compress_grads(grads, error):
    """Returns (int8 tree, scales tree, new error tree)."""
    leaves, spec = pytree.tree_flatten(grads)
    errors = pytree.tree_leaves(error)
    if len(errors) != len(leaves):
        raise ValueError(f"error tree has {len(errors)} leaves, grads "
                         f"{len(leaves)}")
    qs, ss, es = [], [], []
    for g, e in zip(leaves, errors):
        corrected = g.to(torch.float32) + e
        q, s = _q(corrected)
        qs.append(q)
        ss.append(s)
        es.append(corrected - _dq(q, s, corrected.shape))
    return (pytree.tree_unflatten(qs, spec), pytree.tree_unflatten(ss, spec),
            pytree.tree_unflatten(es, spec))


def decompress_grads(qs, ss, shapes):
    """Dequantize: ``shapes`` is a tree whose leaves have ``.shape`` (the
    gradients themselves, as in the reference)."""
    return pytree.tree_map(lambda q, s, g: _dq(q, s, g.shape), qs, ss,
                           shapes)


def compressed_psum(grads, error, group=None):
    """int8 all-reduce with error feedback across the ranks of ``group``
    (the default process group when None); returns (mean tree, new error
    tree).

    All ranks first agree on a SHARED per-row scale (an all-reduce MAX of
    the local amax: int8 values from different ranks are only summable if
    they share a scale), then the int8 grads are summed exactly in int32
    and dequantized once, in the reference's order of float operations.
    """
    leaves, spec = pytree.tree_flatten(grads)
    errors = pytree.tree_leaves(error)
    if len(errors) != len(leaves):
        raise ValueError(f"error tree has {len(errors)} leaves, grads "
                         f"{len(leaves)}")
    world = float(dist.get_world_size(group))
    outs, new_errors = [], []
    for g, e in zip(leaves, errors):
        corrected = g.to(torch.float32) + e
        flat = corrected.reshape(-1, corrected.shape[-1]) \
            if corrected.ndim > 1 else corrected.reshape(1, -1)
        amax = flat.abs().amax(dim=1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        # divisors are tensors on the operands' device: CUDA divides by a
        # CPU scalar as a multiply by its reciprocal, which rounds
        # differently from the CPU's (and the reference's) division
        s = torch.where(amax == 0, torch.ones_like(amax),
                        amax / amax.new_tensor(127.0))
        q = torch.clamp(torch.round(flat / s[:, None]), -127, 127
                        ).to(torch.int8)
        new_errors.append(corrected - _dq(q, s, corrected.shape))
        q_sum = q.to(torch.int32)
        dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
        outs.append(_dq(q_sum, s, corrected.shape) / s.new_tensor(world))
    return (pytree.tree_unflatten(outs, spec),
            pytree.tree_unflatten(new_errors, spec))
