"""PyTorch + CUDA port of the multi-cycle folded integer multiplier
generator, for an NVIDIA H100.

It imports torch, numpy and the standard library only.  Entry points
(:func:`repro_torch.designs.generate`, :class:`repro_torch.core.bank.Bank`)
run on the CUDA card unless the caller passes ``device="cpu"``; on the
card every bank round goes through hand-written CUDA kernels
(:mod:`repro_torch.kernels`), on the CPU through their plain PyTorch
versions.  :mod:`repro_torch.quant` (int8 matmul) and
:mod:`repro_torch.optim` (int8 gradient compression) follow the same
rule: CUDA tensors launch the kernels, CPU tensors take the plain path.
:mod:`repro_torch.verify` is the plan-time gate ``generate()`` runs,
:mod:`repro_torch.autotune` the Pareto-front search over decompositions,
and :mod:`repro_torch.serving` the online serving loop behind
``CompiledDesign.serve`` (imported on demand: importing it registers the
``slo_edf`` scheduler).  The determinism path: :mod:`repro_torch.exact`
(fixed-point sums, ``exact_psum`` across a process group),
:mod:`repro_torch.rng` (Philox on ``core.mul32x32_64``) and
:mod:`repro_torch.data` (deterministic token sources), each running on
the device of its inputs or the one its caller names.
"""
from . import core, data, designs, exact, kernels, optim, quant, rng, verify

__all__ = ["core", "data", "designs", "exact", "kernels", "optim", "quant",
           "rng", "verify"]
