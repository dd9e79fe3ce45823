"""Sharding resolution for runtime state (caches, tokens, optimizer), as
the JAX package's ``launch/sharding.py``.

Parameters get their specs from the model template (``models.base``,
``Model.param_specs``).  This module covers the remaining state that
exists only at run time, with divisibility-checked fallbacks:

  attention KV caches (..., B, S, KV, hd):
      B -> (pod, data) when divisible, else S -> data (long-context,
      batch=1 decode shards the *cache sequence* across the data axis),
      KV -> model when divisible, else hd -> model.
  ssm conv cache (..., B, W, CH):   B -> data axes, CH -> model
  ssm state      (..., B, H, N, P): B -> data axes, H -> model
  tokens/pos     (B, ...):          B -> data axes

Specs are :class:`repro_torch.models.base.P`; :func:`named` and
:func:`batch_shardings` give DTensor placements.  A mesh is a
``DeviceMesh`` or any object with ``axis_names`` and a ``shape`` dict.
"""
from __future__ import annotations

from ..models.base import P, axis_size, mesh_names, mesh_shape, placements
from .mesh import data_axes


def _div(dim, mesh, axes):
    if not (axes and dim % axis_size(mesh, axes) == 0):
        return None
    # a single-axis tuple collapses to the bare name, as the reference's
    # specs compare
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def batch_spec(mesh, ndim: int, batch_dim_size: int) -> P:
    da = data_axes(mesh)
    first = _div(batch_dim_size, mesh, da)
    return P(*((first,) + (None,) * (ndim - 1)))


def bank_batch_spec(mesh, axis: str, ndim: int, batch_dim_size: int) -> P:
    """Spec for a multiplier-bank batch replicated along one mesh axis.

    Unlike :func:`batch_spec` (which replicates when the batch does not
    divide), bank replicas each need an equal shard, so a batch that
    does not divide is an error, not a fallback."""
    names = mesh_names(mesh)
    if axis not in names:
        raise ValueError(f"axis {axis!r} not in mesh axes {names}")
    if batch_dim_size % mesh_shape(mesh)[axis]:
        raise ValueError(
            f"batch {batch_dim_size} not divisible by mesh axis "
            f"{axis!r} size {mesh_shape(mesh)[axis]}")
    return P(*((axis,) + (None,) * (ndim - 1)))


def attn_cache_spec(mesh, shape) -> P:
    """shape: (*prefix, B, S, KV, hd).

    B -> data axes; if B does not divide (B = 1, long-context decode)
    the cache *sequence* shards across data instead.  The model axis
    takes KV heads when they divide, else head_dim."""
    b, s, kv, hd = shape[-4:]
    prefix = (None,) * (len(shape) - 4)
    names = mesh_names(mesh)
    b_ax = _div(b, mesh, data_axes(mesh))
    s_ax = None
    if b_ax is None:
        s_ax = _div(s, mesh, "data" if "data" in names else None)
    model = "model" if "model" in names else None
    kv_ax = _div(kv, mesh, model)
    hd_ax = None
    if kv_ax is None:
        hd_ax = _div(hd, mesh, model)
    return P(*(prefix + (b_ax, s_ax, kv_ax, hd_ax)))


def ssm_conv_spec(mesh, shape) -> P:
    b, _, ch = shape[-3:]
    prefix = (None,) * (len(shape) - 3)
    b_ax = _div(b, mesh, data_axes(mesh))
    ch_ax = _div(ch, mesh, "model" if "model" in mesh_names(mesh) else None)
    return P(*(prefix + (b_ax, None, ch_ax)))


def ssm_state_spec(mesh, shape) -> P:
    b, h, _, _ = shape[-4:]
    prefix = (None,) * (len(shape) - 4)
    b_ax = _div(b, mesh, data_axes(mesh))
    h_ax = _div(h, mesh, "model" if "model" in mesh_names(mesh) else None)
    return P(*(prefix + (b_ax, h_ax, None, None)))


def cache_specs(cache_tree, mesh):
    """Spec tree for a cache tree of shaped leaves (anything with a
    ``shape``: tensors, ``TensorSpec``s), keyed by the leaf's name:
    ``k``/``v`` (attention), ``k_scale``/``v_scale`` (the int8 cache's
    scales), ``conv`` and ``state`` (SSM).  Dicts and lists nest."""
    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            return type(node)(walk(v, key) for v in node)
        shape = tuple(node.shape)
        if key in ("k", "v"):
            return attn_cache_spec(mesh, shape)
        if key in ("k_scale", "v_scale"):
            # (*prefix, B, S, KV): the same layout less the head_dim axis
            return P(*attn_cache_spec(mesh, shape + (1,))[:-1])
        if key == "conv":
            return ssm_conv_spec(mesh, shape)
        if key == "state":
            return ssm_state_spec(mesh, shape)
        raise ValueError(f"unknown cache leaf {key!r}")
    return walk(cache_tree, None)


def named(mesh, spec_tree):
    """A spec tree -> DTensor placements on ``mesh`` (same nesting)."""
    if isinstance(spec_tree, P):
        return placements(spec_tree, mesh)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    return type(spec_tree)(named(mesh, v) for v in spec_tree)


def batch_shardings(batch_specs_tree, mesh) -> dict:
    """Placements for a train/prefill input dict of shaped leaves."""
    return {k: placements(batch_spec(mesh, len(sds.shape), sds.shape[0]),
                          mesh)
            for k, sds in batch_specs_tree.items()}
