"""``repro_torch.launch.roofline.count_kernel_launches`` (the port's
counterpart of the reference's ``count_pallas_launches``): the kernel
names it looks for are ``csrc/``'s, the plain versions on the CPU launch
none, a launch the wrappers counted but the profiler did not see raises,
and on the card (``cuda`` marker; no jax here, so the chip
machine collects this file) one fused round counts 1 launch, as the
launch counters and ``bank.launch_count`` do, and two rounds 2.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch import designs as TD
from repro_torch import telemetry
from repro_torch.core import limbs as TL
from repro_torch.kernels import _build
from repro_torch.launch import roofline as TR


def test_kernel_names_are_the_csrc_kernels():
    names = TR.kernel_names()
    for want in ("bank_fold_kernel", "bank_fold_bulk_kernel", "fold_kernel",
                 "kara_fold_kernel", "prefix_adder_kernel",
                 "int8_wgmma_kernel"):
        assert want in names
    own = re.compile(r"\b(" + "|".join(names) + r")\b")
    assert own.search("void bank_fold_kernel<8>(unsigned int const*)")
    assert not own.search("void at::native::elementwise_kernel<128>()")


def test_plain_versions_on_the_cpu_launch_nothing():
    design = TD.generate("tp3p5_w32", device="cpu")
    a = TL.from_numpy(np.ones((64, 2), np.int32) * 3, "cpu")
    assert TR.count_kernel_launches(design.mul, a, a) == 0


def test_a_launch_the_profiler_missed_raises():
    """A blind profiler (no device events) must not pass for 0 launches:
    a wrapper's count that no device event matches raises."""
    name = next(iter(_build.launch_counts()))

    def unseen():
        telemetry.count(f"launch.{name}")
    with pytest.raises(RuntimeError, match="saw 0 launches"):
        TR.count_kernel_launches(unseen)


@pytest.mark.cuda
def test_kernel_launches_counted_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the profiler counts the hand-"
                    "written kernels' launches there")
    design = TD.generate("tp3p5_w32")
    gen = np.random.default_rng(0)
    a = TL.from_numpy(gen.integers(0, 1 << 16, (65536, 2), dtype=np.int32),
                      "cuda")
    _build.reset_launch_counts()
    n = TR.count_kernel_launches(design.mul, a, a)
    assert n == 1 == sum(_build.launch_counts().values())

    def twice(x):
        design.mul(x, x)
        design.mul(x, x)
    assert TR.count_kernel_launches(twice, a) == 2
