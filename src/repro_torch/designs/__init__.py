"""repro_torch.designs: the design-generator API of the PyTorch port.

    from repro_torch import designs

    spec = designs.DesignSpec(32, 32, throughput=3.5)   # declarative
    d = designs.generate(spec)                # compiled, on the CUDA card
    d.mul(a, b)             # int32 limb tensors on d.device (or two ints)
    d.area, d.latency_cycles, d.fmax_estimate, d.throughput
    d.report(batch)         # cycle accounting
    d.to_json()             # lossless provenance -> DesignSpec.from_json

``generate(spec, device="cpu")`` runs the plain PyTorch path instead.
Named design points (the paper's Table VIII rows, the Sec. V-E
use-case banks, the low-power points) are pre-registered:
``designs.generate("tp3p5_w32")``.
"""
from .spec import (DesignSpec, DesignError, TimingError, LatencyError,
                   MAX_TP_DENOMINATOR)
from .compile import CompiledDesign, generate, compile_plan
from .registry import (register, get, names, TABLE_VIII, USE_CASES,
                       LOW_POWER)

__all__ = [
    "DesignSpec", "CompiledDesign", "generate", "compile_plan",
    "DesignError", "TimingError", "LatencyError", "MAX_TP_DENOMINATOR",
    "register", "get", "names", "TABLE_VIII", "USE_CASES", "LOW_POWER",
]
