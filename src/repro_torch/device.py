"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with
``device=None`` they take ``cuda`` and raise when no CUDA device is
present.  They never drop to the CPU on their own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (or ``RuntimeError``); else the named device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path")
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device} requested but CUDA is not "
                               f"available")
        if device.index is None:     # pin it, so tensors compare equal
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
