"""Backend registry: how one bank instance multiplies.

Counterpart of the reference's ``core/bank/backends.py``.  Registered
``InstanceBackend`` objects are keyed by ``(arch, capability)``:

  * ``arch``        -- the planner architecture: star | fb | ff | karatsuba
  * ``capability``  -- the execution substrate: "core" (plain PyTorch
                       ``mcim_mul``), "kernel" (one ``mcim_fold`` kernel
                       launch per busy instance) or "fused" (the whole
                       bank round as ONE ``bank_fold`` kernel launch).

The "fused" capability is bank-level: its dispatch is built by
``kernels.bank_fold.make_fused_dispatch`` over the whole instance list,
so its ``make_mul`` is the per-instance kernel path, and its
``working_set`` is the time-shared datapath's figure -- the same for
every instance and not summed across the bank (see ``Bank.report``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from ..mcim import MCIMConfig, mcim_mul
from repro_torch.kernels import bank_fold, mcim_fold

CAPABILITIES = ("core", "kernel", "fused")


@dataclasses.dataclass(frozen=True)
class InstanceBackend:
    """One (arch, capability) execution strategy for a bank instance.

    ``make_mul(cfg, la, lb)`` returns the batched multiplier
    ``(B, LA) x (B, LB) -> (B, LA+LB)`` for that instance;
    ``working_set(cfg, la, lb, tile_b)`` the reference's per-step
    working-set figure in bytes (the analogue of the paper's area).
    """
    arch: str
    capability: str
    make_mul: Callable        # (MCIMConfig, la, lb) -> batched mul fn
    working_set: Callable     # (MCIMConfig, la, lb, tile_b) -> bytes


_REGISTRY: dict = {}


def register_backend(backend: InstanceBackend) -> InstanceBackend:
    _REGISTRY[(backend.arch, backend.capability)] = backend
    return backend


def get_backend(arch: str, capability: str) -> InstanceBackend:
    try:
        return _REGISTRY[(arch, capability)]
    except KeyError:
        raise ValueError(
            f"no backend registered for arch={arch!r} "
            f"capability={capability!r}; "
            f"registered: {sorted(_REGISTRY)}") from None


def registered_backends() -> tuple:
    """Snapshot of the registry keys (arch, capability)."""
    return tuple(sorted(_REGISTRY))


# ------------------------------------------------------------- core backends

def _core_mul(cfg: MCIMConfig, la: int, lb: int):
    return functools.partial(mcim_mul, config=cfg)


def _working_set(cfg: MCIMConfig, la: int, lb: int, tile_b: int) -> int:
    """The kernel family's working-set figure; the core capability
    reports the same one (it models the *design*, not the substrate)."""
    if cfg.arch == "star":
        return mcim_fold.vmem_bytes_per_step(la, lb, 1, tile_b)
    if cfg.arch in ("ff", "karatsuba"):
        return mcim_fold.vmem_bytes_per_step(la, lb, cfg.ct, tile_b,
                                             schedule=cfg.arch)
    return mcim_fold.vmem_bytes_per_step(la, lb, cfg.ct, tile_b)


# ----------------------------------------------------------- kernel backends

def _kernel_fold_mul(cfg: MCIMConfig, la: int, lb: int):
    if cfg.arch == "star":
        return functools.partial(mcim_fold.big_mul, ct=1, schedule="fb")
    if cfg.arch == "karatsuba":
        return functools.partial(mcim_fold.big_mul, ct=3,
                                 schedule="karatsuba")
    return functools.partial(mcim_fold.big_mul, ct=cfg.ct,
                             schedule=cfg.arch)


# ------------------------------------------------------------ fused backends

def _fused_working_set(cfg: MCIMConfig, la: int, lb: int,
                       tile_b: int) -> int:
    """Figure of the fused datapath ALL instances time-share
    (independent of ``cfg``)."""
    return bank_fold.vmem_bytes_per_step(la, lb, tile_b)


for _arch in ("star", "fb", "ff", "karatsuba"):
    register_backend(InstanceBackend(_arch, "core", _core_mul,
                                     _working_set))
    register_backend(InstanceBackend(_arch, "kernel", _kernel_fold_mul,
                                     _working_set))
    register_backend(InstanceBackend(_arch, "fused", _kernel_fold_mul,
                                     _fused_working_set))
del _arch


# --------------------------------------------------------------- mul caching

@functools.lru_cache(maxsize=256)
def cached_mul(arch: str, capability: str, cfg: MCIMConfig,
               la: int, lb: int) -> Callable:
    """Backend multiplier shared across ``Bank`` instantiations with the
    same frozen ``(arch, capability, cfg, la, lb)`` key."""
    return get_backend(arch, capability).make_mul(cfg, la, lb)
