"""The 381-bit bank (``tp5over6_w381``, BLS12-381's base field): 24-limb
rows through the port's generator, its plan-time gate and its kernels.

The CPU tests hold ``designs.generate(...).mul`` (the fused bank and the
per-instance kernel backend, on their plain versions) to Python's
integers and to the benchmark's plain reference (``portbench/reference.py``),
and the gate to the new width limit.  The tests marked ``cuda`` hold the
24-limb kernels (both ``bank_fold`` paths, FB and FF on both paths, the
folded and the spatial Karatsuba at N = 18-24) and the design's ``mul``
and ``serve`` on the card to the plain versions; they skip without a
card, and nothing here imports jax, so ``python -m pytest -m cuda
tests/test_torch_w381.py`` runs on the card's machine.
"""
import dataclasses
import importlib.util
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import designs, serving, telemetry
from repro_torch.core import limbs as L
from repro_torch.core.bank import Bank
from repro_torch.core.mcim import MCIMConfig
from repro_torch.kernels import _build, _row_tiles, introspect
from repro_torch.kernels import bank_fold as TB
from repro_torch.kernels import karatsuba_ppm as TK
from repro_torch.kernels import mcim_fold as TF
from repro_torch.verify import dataflow as TDF

SPEC = designs.DesignSpec(381, 381, Fraction(5, 6))
LIMBS = 24
TOP = (1 << 381) - 1
ROWS = (1, 3, 257, 4099)
#: "auto" is the plain core bank on the CPU (the fused bank on the card)
BACKENDS = ("auto", "fused", "kernel")
#: the plan ``generate`` makes of it: 1x fb(ct=2) + 1x karatsuba(ct=3,
#: three levels, 3CA)
CONFIGS = ((1, MCIMConfig(arch="fb", ct=2)),
           (1, MCIMConfig(arch="karatsuba", ct=3, levels=3, adder="3ca")))


def _reference():
    """``portbench/reference.py``, loaded from its file."""
    path = Path(__file__).resolve().parents[1] / "portbench" / "reference.py"
    spec = importlib.util.spec_from_file_location("portbench_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there (the CPU path is their plain version)")
    return torch.device("cuda", torch.cuda.current_device())


def _operands(seed, rows, bits_a=381, bits_b=None):
    rng = np.random.default_rng(seed)
    return (L.random_limbs(rng, (rows,), bits_a),
            L.random_limbs(rng, (rows,), bits_b or bits_a))


def _ints(x) -> list:
    return L.batch_from_limbs(x)


def _design(backend, device="cpu"):
    return designs.generate(dataclasses.replace(SPEC, backend=backend),
                            device=device)


# ------------------------------------------------------------- the design

def test_registered_and_planned_as_the_paper_plans_it():
    assert designs.get("tp5over6_w381") == SPEC
    d = designs.generate("tp5over6_w381", device="cpu")
    assert d.bank.backend == "core"
    assert d.plan.configs == CONFIGS
    assert d.plan.throughput == Fraction(5, 6)
    assert L.n_limbs_for_bits(381) == LIMBS


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("rows", ROWS)
def test_mul_equals_integers_and_the_reference(backend, rows):
    d = _design(backend)
    a, b = _operands(rows, rows)
    ta, tb = L.from_numpy(a, "cpu"), L.from_numpy(b, "cpu")
    out = d.mul(ta, tb)
    assert out.shape == (rows, 2 * LIMBS)
    assert _ints(out) == [x * y for x, y in zip(_ints(a), _ints(b))]
    assert torch.equal(out, REF.mul_limbs(ta, tb))


@pytest.mark.parametrize("backend", BACKENDS)
def test_mul_edge_operands(backend):
    d = _design(backend)
    edges = (0, 1, 2, TOP - 1, TOP)
    pairs = [(x, y) for x in edges for y in edges]
    a = L.batch_to_limbs([x for x, _ in pairs], LIMBS)
    b = L.batch_to_limbs([y for _, y in pairs], LIMBS)
    ta, tb = L.from_numpy(a, "cpu"), L.from_numpy(b, "cpu")
    out = d.mul(ta, tb)
    assert _ints(out) == [x * y for x, y in pairs]
    assert torch.equal(out, REF.mul_limbs(ta, tb))
    assert d.mul(TOP, TOP) == TOP * TOP


def test_reference_is_exact_at_24_limbs_and_its_control_is_not():
    a = L.from_numpy(L.batch_to_limbs([TOP] * 4, LIMBS), "cpu")
    assert _ints(REF.mul_limbs(a, a)) == [TOP * TOP] * 4
    wrapped = REF.mul_limbs(a, a, acc_dtype=torch.int32)
    assert _ints(wrapped) != [TOP * TOP] * 4


# ------------------------------------------------------- the gate, widths

def test_plan_proves_clean_on_both_substrates():
    for substrate in ("kernel", "fused"):
        reps = TDF.analyze_plan(381, 381, CONFIGS, substrate=substrate)
        assert reps and all(r.ok for r in reps), [
            r.violations for r in reps]
    fused = TDF.analyze_plan(381, 381, CONFIGS, "fused")[0]
    assert fused.kernel == "bank_fold_bulk_launch" and fused.path == "bulk"
    kernel = {r.kernel: r.path
              for r in TDF.analyze_plan(381, 381, CONFIGS, "kernel")}
    assert kernel == {"mcim_fold_bulk_launch": "bulk",
                      "mcim_fold_karatsuba_launch": "per_thread"}


@pytest.mark.parametrize("batch", (977, 1 << 14))
def test_round_of_the_bulk_cell_proves_clean(batch):
    rep = TDF.analyze_contract(TDF.round_contract(381, 381, CONFIGS,
                                                  batch))
    assert rep.ok, rep.violations
    # the walk's 98,320 B and the two instances' 24 limb weights
    assert rep.path == "bulk" and rep.smem["dynamic_bytes"] == 98_512


def _contracts(width):
    cfgs = (MCIMConfig(arch="fb", ct=2), MCIMConfig(arch="karatsuba", ct=3))
    return (TF.launch_contract(width, width, 2, "fb"),
            TF.launch_contract(width, width, 2, "fb", batch=257),
            TF.launch_contract(width, width, 3, "karatsuba"),
            TB.launch_contract(cfgs, width, width),
            TB.launch_contract(cfgs, width, width, rows=513))


@pytest.mark.parametrize("width", (17, 21, LIMBS, _build.MAX_LIMBS))
def test_widths_up_to_the_limit_are_accepted(width):
    for c in _contracts(width):
        rep = TDF.analyze_contract(c)
        assert rep.ok, (c.name, rep.violations)
    _build.check_limbs("bank_fold", width, width)


def test_one_limb_past_the_limit_is_a_launch_width_finding():
    over = _build.MAX_LIMBS + 1
    assert _build.MAX_LIMBS == LIMBS
    for c in _contracts(over):
        assert {v.rule for v in TDF.analyze_contract(c).violations} == {
            "launch-width"}, c.name
    with pytest.raises(ValueError, match="24-limb .384-bit."):
        _build.check_limbs("bank_fold", over, 2)
    with pytest.raises(ValueError, match="2-24"):
        introspect.launch_shape("karatsuba_ppm_launch", (64, 26))


def test_24_limb_rows_take_the_bulk_path_and_their_buckets():
    assert _row_tiles.plan(1 << 20, LIMBS, LIMBS, True) == "bulk"
    assert _row_tiles.plan(1 << 20, LIMBS, LIMBS, False) == "per_thread"
    assert _row_tiles.plan(1001, LIMBS, 23, True) == "per_thread"
    assert [_row_tiles.bucket(n, 1) for n in (16, 17, 24)] == [16, 24, 24]
    c = _row_tiles.bulk_constants(LIMBS)
    assert (c["threads"], c["tile_rows"], c["stages"], c["slots"],
            c["per_sm"], c["bytes"]) == (128, 128, 2, 2, 2, 98_320)
    grid, threads, smem = _row_tiles.bulk_launch("bank_fold", 1 << 20,
                                                 LIMBS)
    assert (grid, threads, smem) == ((264, 1), 128, 98_320)
    # the per-thread tile stages 48-limb products at an odd pitch
    assert _row_tiles.tile_launch(24, 1001, 24, 24)[2] == 128 * 49 * 4


def test_wide_launch_counters_are_the_recorders():
    assert set(_build.wide_counts()) == set(telemetry.WIDE_KERNELS)
    assert {f"launch.{k}.wide" for k in telemetry.WIDE_KERNELS} <= set(
        telemetry.COUNTERS)


# --------------------------------------------------------------- the card

def _counted(kernel, fn, *args, **kw):
    """``fn`` once, its launch counted once, and as a wide one."""
    before = _build.launch_counts()[kernel]
    wide = _build.wide_counts()[kernel]
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()[kernel] == before + 1
    assert _build.wide_counts()[kernel] == wide + 1
    return out


def _worst(a, b):
    """All-0xFFFF limbs in the first two rows: the largest columns."""
    a[:2], b[:2] = L.MASK, L.MASK
    return a, b


def _bank_blocks(seed, n_inst, rows, la, lb, device, offset=0):
    """A round of n_inst x R (LA, LB) rows in batch order on ``device``,
    ``offset`` words into their storage (1: 4-byte aligned, not 16), and
    their owners, R an instance, shuffled."""
    out = []
    for x in _worst(*_operands(seed, n_inst * rows, 16 * la, 16 * lb)):
        flat = torch.zeros(x.size + offset, dtype=torch.int32, device=device)
        flat[offset:] = L.from_numpy(x.reshape(-1), device)
        out.append(flat[offset:].view(n_inst * rows, -1))
    owner = np.random.default_rng(seed).permutation(
        np.repeat(np.arange(n_inst, dtype=np.int32), rows))
    return (*out, torch.from_numpy(owner).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,path,offset", [
    (1, "per_thread", 0), (7, "per_thread", 0), (129, "per_thread", 0),
    (1001, "per_thread", 0), (1001, "per_thread", 1), (513, "bulk", 0),
    (629_248, "bulk", 0)])
def test_bank_fold_at_24_limbs_on_card(cuda_device, rows, path, offset):
    cfgs = (MCIMConfig(arch="fb", ct=2), MCIMConfig(arch="karatsuba", ct=3))
    table = torch.from_numpy(TB.super_geometry(cfgs, LIMBS, LIMBS).table()
                             ).to(cuda_device)
    a, b, owner = _bank_blocks(rows, 2, rows, LIMBS, LIMBS, cuda_device,
                               offset)
    assert TB.launch_plan(2, 2 * rows, LIMBS, LIMBS, offset == 0) == (
        "bulk" if offset == 0 else "per_thread")
    got = _counted("bank_fold", TB.fused_bank_mul_kernel, a, b, owner,
                   table, path=path)
    assert torch.equal(got, TB.fused_bank_mul_ref(a, b, owner, table))
    assert _ints(got[:64]) == [x * y for x, y in zip(
        _ints(a[:64]), _ints(b[:64]))]


@pytest.mark.cuda
@pytest.mark.parametrize("path", TB.PATHS)
@pytest.mark.parametrize("la,lb", ((24, 24), (17, 24), (24, 21)))
def test_bank_fold_weights_at_24_limbs_on_card(cuda_device, la, lb, path):
    """40 windows an instance, overlapping (limb weights above 1) and
    idle, as the 8-limb cases of ``test_torch_kernels.py`` have them."""
    if path == "bulk" and la != lb:
        return
    rng = np.random.default_rng(la * 100 + lb)
    n_inst, rows, steps = 3, 1000, 40
    a, b, owner = _bank_blocks(lb, n_inst, rows, la, lb, cuda_device)
    lo = rng.integers(0, lb + 1, size=(n_inst, steps))
    hi = lo + rng.integers(0, lb + 1, size=(n_inst, steps))
    table = np.stack([lo, np.minimum(hi, lb)], axis=-1).astype(np.int32)
    table[:, ::3] = 0
    table = torch.from_numpy(table).to(cuda_device)
    got = _counted("bank_fold", TB.fused_bank_mul_kernel, a, b, owner,
                   table, path=path)
    assert torch.equal(got, TB.fused_bank_mul_ref(a, b, owner, table))


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ("fb", "ff"))
@pytest.mark.parametrize("rows,path", [(1, "per_thread"), (129, "per_thread"),
                                       (1001, "per_thread"), (513, "bulk"),
                                       (1 << 20, "bulk")])
def test_fb_and_ff_at_24_limbs_on_card(cuda_device, schedule, rows, path):
    a, b = (L.from_numpy(x, cuda_device)
            for x in _worst(*_operands(rows, rows)))
    got = _counted(f"mcim_fold_{schedule}", TF.mcim_fold_kernel, a, b,
                   schedule=schedule, path=path)
    assert torch.equal(got, TF.mcim_fold_mul_ref(a, b, ct=2,
                                                 schedule=schedule))
    assert torch.equal(got, REF.mul_limbs(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", (1, 7, 1001, 419_430))
@pytest.mark.parametrize("la,lb", ((24, 24), (17, 17), (20, 19), (23, 24)))
def test_folded_karatsuba_at_24_limbs_on_card(cuda_device, la, lb, rows):
    a, b = (L.from_numpy(x, cuda_device)
            for x in _worst(*_operands(rows, rows, 16 * la, 16 * lb)))
    got = _counted("mcim_fold_karatsuba", TF.mcim_fold_mul, a, b, ct=3,
                   schedule="karatsuba")
    assert torch.equal(got, REF.mul_limbs(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n", (18, 20, 22, 24))
def test_spatial_karatsuba_at_18_to_24_limbs_on_card(cuda_device, n):
    a, b = (L.from_numpy(x, cuda_device)
            for x in _worst(*_operands(n, 4097, 16 * n)))
    got = _counted("karatsuba_ppm", TK.karatsuba_ppm_kernel, a, b,
                   path="per_thread")
    assert torch.equal(got, TK.karatsuba_ppm_mul_ref(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", BACKENDS[1:])
def test_design_mul_on_card_at_the_bulk_cells_batch(cuda_device, backend):
    d = _design(backend, cuda_device)
    a, b = (L.from_numpy(x, cuda_device)
            for x in _worst(*_operands(381, 1 << 20)))
    before = _build.launch_counts()
    wide = _build.wide_counts()
    out = d.mul(a, b)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _build.launch_counts().items()}
    if backend == "fused":
        assert {k: v for k, v in launches.items() if v} == {"bank_fold": 1}
        assert _build.wide_counts()["bank_fold"] == wide["bank_fold"] + 1
    else:
        assert {k: v for k, v in launches.items() if v} == {
            "mcim_fold_fb": 1, "mcim_fold_karatsuba": 1}
    assert torch.equal(out, REF.mul_limbs(a, b))


@pytest.mark.cuda
def test_serve_on_card_equals_cpu(cuda_device):
    card = designs.generate("tp5over6_w381", device=cuda_device)
    cpu = designs.generate("tp5over6_w381", device="cpu")
    assert card.bank.backend == "fused"
    tp = float(card.plan.throughput)
    reqs = serving.synthesize(serving.poisson_arrivals(400, 0.8 * tp, 17),
                              381, 381, budget=max(12, int(32 / tp)),
                              seed=18)
    got = card.serve(reqs, check=True)
    want = cpu.serve(reqs, check=True)
    assert got[1] == want[1]
    assert got[0].bit_exact is True and want[0].bit_exact is True
    plain = Bank(card.plan, 381, 381, backend="core", device=cuda_device)
    a, b = (L.from_numpy(x, cuda_device) for x in _operands(5, 256))
    assert torch.equal(card.bank.execute(a, b), plain.execute(a, b))
