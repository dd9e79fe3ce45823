"""Model stack: the 10 assigned architectures in six families.

:func:`build_model` gives a :class:`Model` on the card unless the caller
passes ``device="cpu"``; :func:`params_from_numpy` carries the JAX
package's parameter tree over.  Attention, the MoE dispatch, the SSD
scan and the primitives are plain functions on tensors (:mod:`.attention`,
:mod:`.moe`, :mod:`.ssm`, :mod:`.base`).
"""
from . import attention, base, encoder, hybrid, moe, ssm, transformer, vlm
from .api import Model, build_model, params_from_numpy

__all__ = ["attention", "base", "encoder", "hybrid", "moe", "ssm",
           "transformer", "vlm", "Model", "build_model", "params_from_numpy"]
