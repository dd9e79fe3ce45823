"""Model stack: the dense decoder family of the 10 assigned architectures.

:func:`build_model` gives a :class:`Model` on the card unless the caller
passes ``device="cpu"``; :func:`params_from_numpy` carries the JAX
package's parameter tree over.  Attention and the primitives are plain
functions on tensors (:mod:`.attention`, :mod:`.base`).
"""
from . import attention, base, transformer
from .api import Model, build_model, params_from_numpy

__all__ = ["attention", "base", "transformer", "Model", "build_model",
           "params_from_numpy"]
