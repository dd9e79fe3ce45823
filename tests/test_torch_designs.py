"""The port's main path as a whole: DesignSpec -> generate -> CompiledDesign
-> Bank -> (fused / kernel / core), held against the JAX reference.

The reference's ``designs.generate()`` runs its static dataflow gate,
which some jax versions cannot complete; so the reference side is built
from its parts instead: ``designs.compile._plan_with_timing`` (dataflow
gate patched out for the test) and ``core.bank.Bank(plan, ...)``.  All
comparisons are integer equality (tolerance 0) on the same numpy
operands, plus the Python-bigint oracle.
"""
import dataclasses
from fractions import Fraction

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.verify
from repro.core import limbs as RL
from repro.core.bank import Bank as RBank
from repro.designs import compile as RC
from repro.designs import registry as RR
from repro_torch import designs as TD
from repro_torch.core import limbs as TL
from repro_torch.core import planner as TP
from repro_torch.core.bank import Bank as TBank
from repro_torch.core.mcim import MCIMConfig
from repro_torch.designs import compile as TC

NAMES = RR.names()
#: the kernel capability is unsigned-only (every registry design is)
UNSIGNED_NAMES = tuple(n for n in NAMES if not RR.get(n).signed)


@pytest.fixture
def ref_plan(monkeypatch):
    """The plan the reference's generate() picks, without its dataflow gate."""
    monkeypatch.setattr(repro.verify, "assert_plan_dataflow",
                        lambda *a, **k: None)

    def plan(spec):
        return RC._plan_with_timing(spec)[0]
    return plan


def _operands(seed, batch, bits):
    rng = np.random.default_rng(seed)
    return RL.random_limbs(rng, (batch,), bits), \
        RL.random_limbs(rng, (batch,), bits)


def _cpu(x):
    return TL.from_numpy(x, "cpu")


def _oracle(a, b, signed=False):
    la, lb = a.shape[-1], b.shape[-1]
    out = []
    for x, y in zip(a, b):
        x, y = RL.from_limbs(x), RL.from_limbs(y)
        if signed:
            x -= (x >> (16 * la - 1)) << (16 * la)
            y -= (y >> (16 * lb - 1)) << (16 * lb)
        out.append((x * y) % (1 << (16 * (la + lb))))
    return out


def _plan_key(plan):
    return ([(n, dataclasses.asdict(c)) for n, c in plan.configs],
            plan.throughput, plan.area, plan.describe())


# ---------------------------------------------------- plans and provenance

@pytest.mark.parametrize("name", NAMES)
def test_plan_spec_and_figures_match_reference(name, ref_plan):
    ref_spec = RR.get(name)
    spec = TD.DesignSpec.from_json(ref_spec.to_json())
    assert spec == TD.get(name)
    assert spec.to_json() == ref_spec.to_json()
    plan = TC._plan_with_timing(spec)[0]
    rplan = ref_plan(ref_spec)
    assert _plan_key(plan) == _plan_key(rplan)

    design = TD.generate(name, device="cpu")
    assert design.bank.backend == "core"         # auto on the CPU
    ref = RC.CompiledDesign(ref_spec, rplan,
                            RBank(rplan, ref_spec.bits_a, ref_spec.bits_b,
                                  scheduler=ref_spec.scheduler))
    for prop in ("area", "latency_cycles", "fmax_estimate",
                 "energy_per_op_pj", "peak_power_mw", "throughput"):
        assert getattr(design, prop) == getattr(ref, prop), prop
    assert design.to_json() == ref.to_json()
    for batch in (1, 7, 64):
        got, want = design.report(batch), ref.report(batch)
        assert [dataclasses.asdict(i.config) for i in got.instances] == \
            [dataclasses.asdict(i.config) for i in want.instances]
        for f in ("batch", "cycles", "plan_throughput", "working_set_bytes",
                  "scheduler", "latency_hist", "energy_per_op_pj",
                  "peak_power_mw"):
            assert getattr(got, f) == getattr(want, f), f
        assert [(i.n_ops, i.busy_cycles) for i in got.instances] == \
            [(i.n_ops, i.busy_cycles) for i in want.instances]
    trace = (0, 0, 1, 3, 3, 3, 8)
    assert design.replay(trace).cycles == ref.replay(trace).cycles


# --------------------------------------------------------- bit exactness

@pytest.mark.parametrize("name", NAMES)
def test_mul_matches_reference_core_bank(name, ref_plan):
    ref_spec = RR.get(name)
    rplan = ref_plan(ref_spec)
    a, b = _operands(len(name), 11, ref_spec.bits_a)
    want = RBank(rplan, ref_spec.bits_a, ref_spec.bits_b,
                 backend="core").execute(jnp.asarray(a), jnp.asarray(b))
    for backend in ("core", "fused", "kernel"):
        spec = dataclasses.replace(TD.get(name), backend=backend)
        got = TD.generate(spec, device="cpu").mul(_cpu(a), _cpu(b))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int32))
    assert TL.batch_from_limbs(got) == _oracle(a, b)


@pytest.mark.parametrize("backend", ("kernel", "fused"))
@pytest.mark.parametrize("name", UNSIGNED_NAMES)
def test_mul_matches_reference_kernel_banks(name, backend, ref_plan):
    """The reference's Pallas banks (interpret mode) against the port's
    plain versions of the same capability."""
    ref_spec = RR.get(name)
    rplan = ref_plan(ref_spec)
    a, b = _operands(7, 9, ref_spec.bits_a)
    want = RBank(rplan, ref_spec.bits_a, ref_spec.bits_b,
                 backend=backend).execute(jnp.asarray(a), jnp.asarray(b))
    spec = dataclasses.replace(TD.get(name), backend=backend)
    design = TD.generate(spec, device="cpu")
    assert design.bank.backend == backend
    got = design.mul(_cpu(a), _cpu(b))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))
    assert TL.batch_from_limbs(got) == _oracle(a, b)


@pytest.mark.parametrize("batch", (1, 2, 7, 13, 29, 97))
def test_fused_ragged_and_prime_batches(batch):
    """Padded gather rows must never reach the products (op 0 included)."""
    design = TD.generate(dataclasses.replace(TD.get("tp3p5_w32"),
                                             backend="fused"), device="cpu")
    a, b = _operands(batch, batch, 32)
    assert TL.batch_from_limbs(design.mul(_cpu(a), _cpu(b))) == \
        _oracle(a, b)


@pytest.mark.parametrize("name", ("tp3p5_w32", "tp5over6_w128"))
def test_signed_fused_matches_reference(name, ref_plan):
    ref_spec = dataclasses.replace(RR.get(name), signed=True)
    rplan = ref_plan(ref_spec)
    a, b = _operands(3, 10, ref_spec.bits_a)
    want = RBank(rplan, ref_spec.bits_a, ref_spec.bits_b,
                 backend="core").execute(jnp.asarray(a), jnp.asarray(b))
    spec = dataclasses.replace(TD.get(name), signed=True, backend="fused")
    design = TD.generate(spec, device="cpu")
    got = design.mul(_cpu(a), _cpu(b))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))
    assert TL.batch_from_limbs(got) == _oracle(a, b, signed=True)
    assert design.mul(-7, 123456) == -7 * 123456
    assert design.mul(-(1 << (spec.bits_a - 1)), -1) == \
        1 << (spec.bits_a - 1)


def test_python_int_mul():
    design = TD.generate("tp3p5_w32", device="cpu")
    assert design.mul(0xDEADBEEF, 0xCAFEBABE) == 0xDEADBEEF * 0xCAFEBABE
    with pytest.raises(ValueError):
        design.mul(1 << 32, 1)
    with pytest.raises(ValueError):
        design.mul(-1, 1)


# ------------------------------------------------------- launch accounting

def test_launch_count_per_capability():
    plan = TP.plan_throughput(32, 32, Fraction(7, 2))
    assert TBank(plan, 32, 32, backend="fused",
                 device="cpu").launch_count(11) == 1
    assert TBank(plan, 32, 32, backend="kernel",
                 device="cpu").launch_count(11) == 4
    assert TBank(plan, 32, 32, backend="kernel",
                 device="cpu").launch_count(2) == 2   # two busy instances
    assert TBank(plan, 32, 32, backend="core",
                 device="cpu").launch_count(11) == 0


# ------------------------------------------------------------ refusals

def _bank():
    return TD.generate("tp3p5_w32", device="cpu")


def test_batch_mismatch_and_limb_width_raise():
    a, b = _operands(1, 4, 32)
    with pytest.raises(ValueError, match="batch mismatch"):
        _bank().mul(_cpu(a), _cpu(b[:3]))
    with pytest.raises(ValueError, match="limbs"):
        _bank().mul(_cpu(a[:, :1]), _cpu(b[:, :1]))


def test_operands_must_be_int32_on_the_banks_device():
    a, b = _operands(2, 4, 32)
    with pytest.raises(ValueError, match="int32"):
        _bank().mul(_cpu(a).long(), _cpu(b).long())
    meta = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="bank runs on"):
        _bank().mul(meta, meta)
    with pytest.raises(TypeError):
        _bank().mul(a, b)                         # numpy, not tensors


def test_mixed_signedness_refused_on_fused():
    plan = TP.Plan(configs=((1, MCIMConfig("star", 1)),
                            (1, MCIMConfig("fb", 2, signed=True))),
                   throughput=Fraction(3, 2), area=0.0)
    with pytest.raises(ValueError, match="uniform signedness"):
        TBank(plan, 32, 32, backend="fused", device="cpu")


def test_signed_kernel_refused():
    spec = dataclasses.replace(TD.get("tp3p5_w32"), signed=True,
                               backend="kernel")
    with pytest.raises(TD.DesignError, match="unsigned-only"):
        TD.generate(spec, device="cpu")


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.generate("tp3p5_w32")
    with pytest.raises(RuntimeError):
        TD.generate("tp3p5_w32", device="cuda")
    with pytest.raises(RuntimeError):
        TBank(TP.plan_throughput(32, 32, 2), 32, 32)


# ------------------------------------------------------------- replicas

REPLICATED = ("tp3p5_w32", "tp5over6_w128")

REFERENCE_MESH = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
import repro.verify
from repro.designs import compile as RC, registry as RR, DesignError

# the dataflow gate some jax versions cannot complete (module docstring)
repro.verify.assert_plan_dataflow = lambda *a, **k: None
names, out = json.loads(sys.argv[1]), sys.argv[2]
ops = dict(np.load(out + ".in.npz"))
mesh2 = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("data",))
mesh4 = jax.sharding.Mesh(np.asarray(jax.devices()), ("data",))
res, errors = {}, {}
for name in names:
    for backend in ("core", "fused", "kernel"):
        spec = dataclasses.replace(RR.get(name), replicas=2, backend=backend)
        d = RC.generate(spec, mesh=mesh2)
        res[f"{name}-{backend}"] = np.asarray(
            d.mul(ops[f"{name}_a"], ops[f"{name}_b"]))
spec = dataclasses.replace(RR.get("tp3p5_w32"), replicas=2)
for label, fn in (("mesh_size", lambda: RC.generate(spec, mesh=mesh4)),
                  ("too_many", lambda: RC.generate(
                      dataclasses.replace(spec, replicas=5)))):
    try:
        fn()
    except DesignError as e:
        errors[label] = str(e)
np.savez(out, **res)
with open(out + ".json", "w") as f:
    json.dump(errors, f)
"""


@pytest.fixture(scope="module")
def reference_mesh(tmp_path_factory):
    """The reference's replicated designs on a 2-device placeholder mesh
    (a subprocess: the device count is set before jax is imported)."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    out = str(tmp_path_factory.mktemp("replicas") / "ref")
    np.savez(out + ".in.npz", **{
        f"{n}_{x}": _operands(5, 12, RR.get(n).bits_a)[i]
        for n in REPLICATED for i, x in enumerate("ab")})
    src = pathlib.Path(__file__).resolve().parent.parent / "src"
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_MESH, json.dumps(REPLICATED), out],
        env=dict(os.environ, PYTHONPATH=str(src), JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out + ".json") as f:
        return dict(np.load(out + ".npz")), json.load(f)


@pytest.mark.parametrize("backend", ("core", "fused", "kernel"))
@pytest.mark.parametrize("name", REPLICATED)
def test_replicated_mul_matches_reference_mesh(name, backend,
                                               reference_mesh):
    a, b = _operands(5, 12, RR.get(name).bits_a)
    spec = dataclasses.replace(TD.get(name), replicas=2, backend=backend)
    design = TD.generate(spec, devices=["cpu", "cpu"])
    assert design.devices == (torch.device("cpu"),) * 2
    assert design.bank.backend == backend
    got = design.mul(_cpu(a), _cpu(b))
    np.testing.assert_array_equal(
        got.numpy(), reference_mesh[0][f"{name}-{backend}"].astype(np.int32))
    assert TL.batch_from_limbs(got) == _oracle(a, b)
    assert torch.equal(got, TD.generate(dataclasses.replace(
        spec, replicas=1), device="cpu").mul(_cpu(a), _cpu(b)))


@pytest.mark.parametrize("name", REPLICATED)
def test_replicated_figures_and_report_match_reference(name, ref_plan):
    ref_spec = dataclasses.replace(RR.get(name), replicas=2)
    rplan = ref_plan(ref_spec)
    ref = RC.CompiledDesign(ref_spec, rplan,
                            RBank(rplan, ref_spec.bits_a, ref_spec.bits_b,
                                  scheduler=ref_spec.scheduler))
    spec = dataclasses.replace(TD.get(name), replicas=2)
    design = TD.generate(spec, devices=["cpu", "cpu"])
    single = TD.generate(name, device="cpu")
    for prop in ("area", "latency_cycles", "fmax_estimate",
                 "energy_per_op_pj", "peak_power_mw", "throughput"):
        assert getattr(design, prop) == getattr(ref, prop), prop
    assert design.throughput == 2 * single.throughput
    assert design.area == 2 * single.area
    assert design.peak_power_mw == 2 * single.peak_power_mw
    for batch in (2, 14, 64):
        got, want = design.report(batch), ref.report(batch)
        assert got.batch == want.batch == batch // 2
        for f in ("cycles", "plan_throughput", "working_set_bytes",
                  "scheduler", "latency_hist", "energy_per_op_pj",
                  "peak_power_mw"):
            assert getattr(got, f) == getattr(want, f), f
        assert [(i.n_ops, i.busy_cycles) for i in got.instances] == \
            [(i.n_ops, i.busy_cycles) for i in want.instances]
    with pytest.raises(ValueError, match="does not divide over 2 replicas"):
        design.report(7)
    with pytest.raises(ValueError, match="does not divide over 2 replicas"):
        ref.report(7)


def test_replica_device_errors_match_reference(reference_mesh, monkeypatch):
    messages = reference_mesh[1]
    spec = dataclasses.replace(TD.get("tp3p5_w32"), replicas=2)
    with pytest.raises(TD.DesignError) as err:
        TD.generate(spec, devices=["cpu"] * 4)
    assert str(err.value) == messages["mesh_size"]
    with pytest.raises(TD.DesignError):
        TD.compile_plan(spec, TD.generate("tp3p5_w32", device="cpu")
                        .plan.configs, devices=["cpu"])
    # a machine with 4 cards asked for 5 replicas
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(TD.DesignError) as err:
        TD.generate(dataclasses.replace(spec, replicas=5))
    want = messages["too_many"]
    assert str(err.value).split(" (")[0] == want.split(" (")[0]
    assert "explicit devices" in str(err.value)


def test_replicated_defaults_and_python_ints():
    spec = dataclasses.replace(TD.get("tp3p5_w32"), replicas=2)
    design = TD.generate(spec, device="cpu")
    assert design.devices == (torch.device("cpu"),) * 2
    assert design.mul(0xDEADBEEF, 0xCAFEBABE) == 0xDEADBEEF * 0xCAFEBABE
    assert TD.generate("tp3p5_w32", device="cpu").devices is None
    explicit = TD.compile_plan(spec, design.plan.configs,
                               devices=["cpu", "cpu"])
    assert explicit.devices == design.devices
    assert explicit.area == design.area
    a, b = _operands(9, 6, 32)
    assert torch.equal(explicit.mul(_cpu(a), _cpu(b)),
                       design.mul(_cpu(a), _cpu(b)))
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        design.mul(_cpu(a[:5]), _cpu(b[:5]))


def test_compile_plan_matches_generate():
    spec = TD.get("tp5over6_w128")
    design = TD.generate(spec, device="cpu")
    explicit = TD.compile_plan(spec, design.plan.configs, device="cpu")
    assert explicit.area == design.area
    a, b = _operands(4, 6, 128)
    assert torch.equal(explicit.mul(_cpu(a), _cpu(b)),
                       design.mul(_cpu(a), _cpu(b)))
    with pytest.raises(TD.DesignError):
        TD.compile_plan(spec, ((1, MCIMConfig("fb", 2)),), device="cpu")
