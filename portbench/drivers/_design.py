"""What the drivers of a ``CompiledDesign`` share: the design built from
a configuration file, the host spans around its bank, and the control
in the bank's place."""
from __future__ import annotations

from contextlib import contextmanager

import torch

from portbench import reference


class DesignDriver:
    """Builds ``designs.generate(DesignSpec.from_dict(config["spec"]))``
    on ``device``."""

    def __init__(self, config: dict, device: torch.device, mark):
        from repro_torch import designs
        mark("repro_torch")
        spec = designs.DesignSpec.from_dict(config["spec"])
        if device.type == "cuda":
            torch.cuda.init()
            torch.empty(1, device=device)
            mark("cuda context")
        self.design = designs.generate(spec, device=device)
        self.device = device
        mark("generate")

    def release(self) -> None:
        self.design = None

    @staticmethod
    @contextmanager
    def control():
        """The reference with int32 column sums in the place of
        ``Bank.execute``."""
        from repro_torch.core.bank import Bank
        execute = Bank.execute
        Bank.execute = lambda bank, a, b: reference.mul_limbs(
            a, b, acc_dtype=torch.int32)
        try:
            yield
        finally:
            Bank.execute = execute

    @staticmethod
    def span_targets() -> list:
        """``report``: the host cycle accounting every ``execute`` runs;
        ``execute``: dispatch build and enqueue, holding ``report``, and
        then ``wait`` for the round's device work; ``copy``: the
        worker's operand copies to the card."""
        from repro_torch.core import limbs
        from repro_torch.core.bank import Bank
        return [(Bank, "report", "report", False),
                (Bank, "execute", "execute", True),
                (limbs, "from_numpy", "copy", False)]
