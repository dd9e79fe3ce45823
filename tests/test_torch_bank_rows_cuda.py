"""The fused bank round in batch order on the card.

A round's launch takes the caller's rows as they lie, ``(B, LA) x (B,
LB) -> (B, LA+LB)``, and an owner table naming the instance whose
windows weight each row (``kernels/bank_fold``).  Here, on the card:
the launch against its plain version on both paths at every compiled
width, at batches around the tiles and at 2**20 rows; one fused round is
one device kernel and no gather or index kernel; operands that are not
contiguous are copied and counted; and the ``mcim_fold`` kernels, which
share the tile walks of ``csrc/row_tiles.cuh``, keep the attributes they
compile to.  Every test needs a CUDA card (marker ``cuda``) and skips
without one; nothing imports jax.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import designs, telemetry
from repro_torch.core import limbs as L
from repro_torch.kernels import _build, _row_tiles
from repro_torch.kernels import bank_fold as TB

pytestmark = pytest.mark.cuda

WIDTHS = (2, 4, 8, 16, 24)
BATCHES = (1, 7, 257, 1 << 20)

#: (registers, local bytes, static shared bytes, most threads a block) of
#: the kernels that share the row-tile walks with bank_fold, by their
#: ``*_attributes`` entry and its arguments: what they compile to on the
#: H100 with constant owners and weights, which the walks' row-by-row
#: lookup for bank_fold must leave as it is
MCIM_ATTRIBUTES = {
    ("mcim_fold", "mcim_fold_attributes", (1000, 1, 1)):
        (16, 0, 0, 128),
    ("mcim_fold", "mcim_fold_attributes", (1000, 2, 2)):
        (16, 0, 0, 128),
    ("mcim_fold", "mcim_fold_attributes", (1000, 3, 3)):
        (32, 0, 0, 128),
    ("mcim_fold", "mcim_fold_attributes", (1000, 4, 4)):
        (32, 0, 0, 128),
    ("mcim_fold", "mcim_fold_attributes", (1000, 5, 5)):
        (32, 0, 0, 128),
    ("mcim_fold", "mcim_fold_attributes", (1000, 8, 8)):
        (32, 0, 0, 128),
    ("mcim_fold", "mcim_fold_attributes", (1000, 13, 13)):
        (56, 0, 0, 128),
    ("mcim_fold", "mcim_fold_attributes", (1000, 16, 16)):
        (56, 0, 0, 128),
    ("mcim_fold", "mcim_fold_attributes", (1000, 17, 17)):
        (80, 0, 0, 128),
    ("mcim_fold", "mcim_fold_attributes", (1000, 24, 24)):
        (80, 0, 0, 128),
    ("mcim_fold", "mcim_fold_bulk_attributes", (1024, 2, 2)):
        (23, 0, 0, 256),
    ("mcim_fold", "mcim_fold_bulk_attributes", (1024, 4, 4)):
        (29, 0, 0, 256),
    ("mcim_fold", "mcim_fold_bulk_attributes", (1024, 8, 8)):
        (56, 0, 0, 128),
    ("mcim_fold", "mcim_fold_bulk_attributes", (1024, 16, 16)):
        (96, 0, 0, 128),
    ("mcim_fold", "mcim_fold_bulk_attributes", (1024, 24, 24)):
        (128, 0, 0, 128),
    ("mcim_fold", "mcim_fold_karatsuba_attributes", (1000, 2, 2)):
        (19, 0, 0, 128),
    ("karatsuba_ppm", "karatsuba_ppm_attributes", (1000, 2)):
        (18, 0, 0, 128),
    ("mcim_fold", "mcim_fold_karatsuba_attributes", (1000, 4, 4)):
        (32, 0, 0, 128),
    ("karatsuba_ppm", "karatsuba_ppm_attributes", (1000, 4)):
        (32, 0, 0, 128),
    ("mcim_fold", "mcim_fold_karatsuba_attributes", (1000, 6, 6)):
        (37, 0, 0, 128),
    ("karatsuba_ppm", "karatsuba_ppm_attributes", (1000, 6)):
        (39, 0, 0, 128),
    ("mcim_fold", "mcim_fold_karatsuba_attributes", (1000, 8, 8)):
        (40, 0, 0, 128),
    ("karatsuba_ppm", "karatsuba_ppm_attributes", (1000, 8)):
        (47, 0, 0, 128),
    ("mcim_fold", "mcim_fold_karatsuba_attributes", (1000, 10, 10)):
        (55, 0, 0, 128),
    ("karatsuba_ppm", "karatsuba_ppm_attributes", (1000, 10)):
        (55, 0, 0, 128),
    ("mcim_fold", "mcim_fold_karatsuba_attributes", (1000, 12, 12)):
        (55, 0, 0, 128),
    ("karatsuba_ppm", "karatsuba_ppm_attributes", (1000, 12)):
        (63, 0, 0, 128),
    ("mcim_fold", "mcim_fold_karatsuba_attributes", (1000, 14, 14)):
        (64, 0, 0, 128),
    ("karatsuba_ppm", "karatsuba_ppm_attributes", (1000, 14)):
        (64, 0, 0, 128),
    ("mcim_fold", "mcim_fold_karatsuba_attributes", (1000, 16, 16)):
        (72, 0, 0, 128),
    ("karatsuba_ppm", "karatsuba_ppm_attributes", (1000, 16)):
        (72, 0, 0, 128),
    ("mcim_fold", "mcim_fold_karatsuba_attributes", (1000, 18, 18)):
        (80, 0, 0, 128),
    ("karatsuba_ppm", "karatsuba_ppm_attributes", (1000, 18)):
        (80, 0, 0, 128),
    ("mcim_fold", "mcim_fold_karatsuba_attributes", (1000, 20, 20)):
        (107, 0, 0, 128),
    ("karatsuba_ppm", "karatsuba_ppm_attributes", (1000, 20)):
        (96, 0, 0, 128),
    ("mcim_fold", "mcim_fold_karatsuba_attributes", (1000, 22, 22)):
        (102, 0, 0, 128),
    ("karatsuba_ppm", "karatsuba_ppm_attributes", (1000, 22)):
        (102, 0, 0, 128),
    ("mcim_fold", "mcim_fold_karatsuba_attributes", (1000, 24, 24)):
        (96, 0, 0, 128),
    ("karatsuba_ppm", "karatsuba_ppm_attributes", (1000, 24)):
        (108, 0, 0, 128),
    ("karatsuba_ppm", "karatsuba_ppm_bulk_attributes", (1024, 2)):
        (25, 0, 0, 256),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there (the CPU path is their plain version)")
    return torch.device("cuda", torch.cuda.current_device())


def _round(batch, la, lb, device, offset=0, seed=0):
    """Random rows of a round ``offset`` words into their storage (1: off
    16 bytes), owners drawn over three instances (fb2, karatsuba3 and a
    star's one window, an idle step between) and their table."""
    rng = np.random.default_rng(seed * 1000 + batch % 1000 + la)
    a = L.random_limbs(rng, (batch,), 16 * la)
    b = L.random_limbs(rng, (batch,), 16 * lb)
    chunk2, chunk3 = -(-lb // 2), -(-lb // 3)
    table = np.zeros((3, 3, 2), np.int32)
    table[0, :2] = [(0, chunk2), (chunk2, lb)]
    table[1] = [(lo, min(lo + chunk3, lb)) for lo in range(0, 3 * chunk3,
                                                            chunk3)]
    table[2, 2] = (0, lb)
    owner = rng.integers(0, 3, batch).astype(np.int32)

    def on_card(x):
        flat = torch.zeros(x.size + offset, dtype=torch.int32, device=device)
        flat[offset:] = L.from_numpy(x.reshape(-1), device)
        return flat[offset:].view(x.shape)

    return (on_card(a), on_card(b), torch.from_numpy(owner).to(device),
            torch.from_numpy(table).to(device))


def _counted(fn, *args, **kwargs):
    before = _build.launch_counts()["bank_fold"]
    got = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert _build.launch_counts()["bank_fold"] == before + 1
    return got


@pytest.mark.parametrize("path", TB.PATHS)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("la", WIDTHS)
def test_batch_order_launch_matches_plain_on_card(cuda_device, la, batch,
                                                  path):
    a, b, owner, table = _round(batch, la, la, cuda_device)
    planned = TB.launch_plan(3, batch, la, la, True)
    if path == "bulk" and planned != "bulk":
        with pytest.raises(ValueError, match="bulk"):
            TB.fused_bank_mul_kernel(a, b, owner, table, path=path)
        return
    before = _build.path_counts()["bank_fold"][path]
    got = _counted(TB.fused_bank_mul_kernel, a, b, owner, table, path=path)
    assert _build.path_counts()["bank_fold"][path] == before + 1
    assert torch.equal(got, TB.fused_bank_mul_ref(a, b, owner, table))
    if batch <= 257:
        assert L.batch_from_limbs(got) == [
            L.from_limbs(x) * L.from_limbs(y) for x, y in zip(
                a.cpu().numpy(), b.cpu().numpy())]


@pytest.mark.parametrize("la", WIDTHS)
def test_batch_order_launch_on_misaligned_views(cuda_device, la):
    """Views 4 bytes off 16 take the per-thread path through the public
    entry point."""
    a, b, owner, table = _round(4099, la, la, cuda_device, offset=1)
    assert not _row_tiles.is_aligned(a, b)
    before = _build.path_counts()["bank_fold"]["per_thread"]
    got = _counted(TB.fused_bank_rows, a, b, owner, table)
    assert _build.path_counts()["bank_fold"]["per_thread"] == before + 1
    assert torch.equal(got, TB.fused_bank_mul_ref(a, b, owner, table))


def _bank_operands(d, batch, device):
    rng = np.random.default_rng(batch)
    return (L.from_numpy(L.random_limbs(rng, (batch,), d.spec.bits_a),
                         device),
            L.from_numpy(L.random_limbs(rng, (batch,), d.spec.bits_b),
                         device))


#: one fused round of a design under ``torch.profiler``, in a process of
#: its own: torch 2.11's profiler can record no device events in a
#: process that profiled before (``launch/roofline.py``
#: ``count_kernel_launches``), so a session here would blind the tests
#: that profile after it
PROFILED_ROUND = """
import json, sys
import numpy as np
import torch
from repro_torch import designs
from repro_torch.core import limbs as L
dev = torch.device("cuda", 0)
d = designs.generate(sys.argv[1], device=dev)
rng = np.random.default_rng(4096)
a = L.from_numpy(L.random_limbs(rng, (4096,), d.spec.bits_a), dev)
b = L.from_numpy(L.random_limbs(rng, (4096,), d.spec.bits_b), dev)
want = d.mul(a, b)                   # the dispatch is built
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    got = d.mul(a, b)
    torch.cuda.synchronize()
print(json.dumps({"kernels": [
    e.name for e in prof.events()
    if e.device_type == torch.autograd.DeviceType.CUDA],
    "equal": bool(torch.equal(got, want))}))
"""


@pytest.mark.parametrize("name", ("tp3p5_w32", "tp5over6_w128"))
def test_fused_round_is_one_bank_fold_kernel(cuda_device, name):
    """A fused round on the card issues exactly one device kernel, the
    bank_fold launch, and no aten gather or index kernel."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(src), os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run([sys.executable, "-c", PROFILED_ROUND, name],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    seen = json.loads(run.stdout.strip().splitlines()[-1])
    kernels = seen["kernels"]
    assert len(kernels) == 1 and "bank_fold" in kernels[0], kernels
    assert not [k for k in kernels if "gather" in k or "index" in k]
    assert seen["equal"]


def test_operand_copies_count_views_that_are_not_contiguous(cuda_device):
    d = designs.generate("tp5over6_w128", device=cuda_device)
    a, b = _bank_operands(d, 1000, cuda_device)

    def copies():
        return telemetry.totals()["counters"]["bank_fold.operand_copies"]

    want = d.mul(a, b)
    before = copies()
    assert torch.equal(d.mul(a, b), want)
    assert copies() == before
    a_t = a.t().contiguous().t()               # the same values, transposed
    assert not a_t.is_contiguous()
    assert torch.equal(d.mul(a_t, b), want)
    torch.cuda.synchronize()
    assert copies() == before + 1


@pytest.mark.parametrize("key", sorted(MCIM_ATTRIBUTES))
def test_mcim_fold_kernels_keep_their_attributes(cuda_device, key):
    lib, symbol, args = key
    assert _build.query(lib, symbol, args) == MCIM_ATTRIBUTES[key]


#: the most registers each ``bank_fold`` kernel may hold on the H100, by
#: its ``*_attributes`` entry and its arguments (n_inst, rows, la, lb,
#: max_steps); none may spill
BANK_FOLD_REGISTERS = {
    ("bank_fold_attributes", (2, 1000, 2, 2, 2)): 27,
    ("bank_fold_attributes", (2, 1000, 4, 4, 2)): 32,
    ("bank_fold_attributes", (2, 1000, 8, 8, 3)): 40,
    ("bank_fold_attributes", (2, 1000, 16, 16, 3)): 80,
    ("bank_fold_attributes", (2, 1000, 24, 24, 3)): 108,
    ("bank_fold_bulk_attributes", (2, 1024, 2, 2, 2)): 32,
    ("bank_fold_bulk_attributes", (2, 1024, 4, 4, 2)): 38,
    ("bank_fold_bulk_attributes", (2, 1024, 8, 8, 3)): 56,
    ("bank_fold_bulk_attributes", (2, 1024, 16, 16, 3)): 96,
    ("bank_fold_bulk_attributes", (2, 1024, 24, 24, 3)): 128,
}


@pytest.mark.parametrize("key", sorted(BANK_FOLD_REGISTERS))
def test_bank_fold_kernels_stay_within_their_registers(cuda_device, key):
    symbol, args = key
    regs, local, _, _ = _build.query("bank_fold", symbol, args)
    assert regs <= BANK_FOLD_REGISTERS[key] and local == 0
