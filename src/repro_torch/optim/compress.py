"""Int8 gradient compression with error feedback, in PyTorch.

Counterpart of the reference's ``optim/compress.py``: gradients are
quantized to int8 with per-row scales before the data-parallel
reduction, and the quantization residual is carried in an
error-feedback buffer so the compression bias vanishes over steps
(Karimireddy et al. 2019).  The quantize/dequantize pair reuses
:func:`repro_torch.kernels.int8_matmul.quantize_rows`.

Trees are any nesting of dicts, lists and tuples of tensors
(``torch.utils._pytree``).  The reference's ``compressed_psum``, a
collective across replicas, comes with the port's sharded banks.
"""
from __future__ import annotations

import torch
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
