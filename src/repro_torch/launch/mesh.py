"""Mesh construction, as the JAX package's ``launch/mesh.py``, on
``torch.distributed``'s ``DeviceMesh``.

Functions, not module-level constants: importing this module touches no
process group and no device.  Each function takes the process group the
caller has initialized (``torch.distributed.init_process_group``; the
trainer's ``maybe_init_distributed`` does it from torch's launcher
variables) and raises without one.

Production topology (the reference's):
  single pod : (16, 16)    -> ("data", "model")          = 256 ranks
  multi-pod  : (2, 16, 16) -> ("pod", "data", "model")   = 512 ranks
The "pod" axis carries only data parallelism (and the gradient
reduction): no tensor-parallel collective crosses it.

A mesh's device type is ``"cuda"`` (one card a rank, or ranks sharing
one) unless the caller passes ``device_type="cpu"``.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..models.base import mesh_names


def _require_world(size: int) -> None:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    if dist.get_world_size() != size:
        raise ValueError(f"the mesh holds {size} ranks, the world "
                         f"{dist.get_world_size()}")


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _require_world(shape[0] * shape[1] * (shape[2] if multi_pod else 1))
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """(world / model_parallel, model_parallel) as ("data", "model")
    over every rank of the world (tests, single-host training)."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} does not "
                         f"divide the world's {n} ranks")
    return init_device_mesh(device_type, (n // model_parallel,
                                          model_parallel),
                            mesh_dim_names=("data", "model"))


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh_names(mesh))
