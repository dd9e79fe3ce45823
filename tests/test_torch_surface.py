"""The port's public surface against the reference's, name by name.

Every public top-level name of each module of ``src/repro/`` (the
definitions, and what a package's ``__init__`` imports), and every
public method of its public classes, has a counterpart of the same name
in the port's mirror module (``repro_torch.<same path>``), or stands in
:data:`NO_COUNTERPART` with the reason it has none.  The table is kept
true both ways: an entry whose name the port now has, or the reference
no longer has, fails.  A package's ``__all__`` is held the same way, in
a fresh interpreter, so the names come from the package's own imports.

Also here, the names this slice added: the one-shot
``core.bank.execute`` / ``last_report`` against the reference's on the
registry's plans (exact integers, reports field for field),
``BACKENDS``, ``limbs.ppm_op_count``, ``LaunchContract.matches_idle``,
the mesh helpers of ``launch``; and the empty round on every backend.
"""
import ast
import dataclasses
import functools
import importlib
import json
import pathlib
import subprocess
import sys
import types
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.verify
from repro.core import bank as RB
from repro.core import limbs as RL
from repro.designs import compile as RC
from repro.designs import registry as RR
from repro.designs import spec as RS
from repro.kernels import introspect as RI
from repro_torch import designs as TD
from repro_torch import launch as TLA
from repro_torch.core import bank as TB
from repro_torch.core import limbs as TL
from repro_torch.kernels import bank_fold
from repro_torch.verify import dataflow as TDF

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"

_JAX = "a JAX-only facility"
#: reference module (path under src/repro) or "module:name" -> why the
#: port has no counterpart of that name
NO_COUNTERPART = {
    "compat.py": "shims across jax versions (shard_map's check_vma); the "
                 "port has no jax",
    "kernels/runtime.py": "the Pallas interpret-mode switch; CUDA kernels "
                          "have no interpret mode (the wrappers run their "
                          "plain versions on CPU tensors)",
    "kernels/int8_matmul/ref.py": "the jnp oracle; the port's plain version "
                                  "is int8_matmul_ref in kernel.py",
    "kernels/karatsuba_ppm/ref.py": "the jnp oracle; the port's plain "
                                    "version is karatsuba_ppm_mul_ref in "
                                    "kernel.py",
    "kernels/mcim_fold/ref.py": "the jnp oracle; the port's plain version "
                                "is mcim_fold_mul_ref in kernel.py",
    "kernels/prefix_adder/ref.py": "the jnp oracle; the port's plain "
                                   "version is prefix_final_adder_ref in "
                                   "kernel.py",
    "launch/hlo_cost.py": "XLA's HLO cost analysis; the port counts ops "
                          "with launch/op_cost.py",
    "verify/jaxpr_walk.py": "walks jaxprs for pallas_call; the port's "
                            "launches are torch.library custom ops",
    "verify/vmem.py": "the TPU VMEM budget of a Pallas kernel; the port's "
                      "shared-memory model is in verify/dataflow.py",
    "verify/__init__.py:jaxpr_walk": "the submodule above",
    "verify/__init__.py:vmem": "the submodule above",
    "kernels/introspect.py:LaunchContract.trace": "returns a jaxpr; "
        "the port's contracts carry the launch itself",
    "verify/dataflow.py:Data": "the abstract values of " + _JAX
        + " (the jaxpr interpreter)",
    "verify/dataflow.py:RefState": "the Pallas ref state of " + _JAX
        + " (the jaxpr interpreter)",
    "verify/dataflow.py:RefState.read": "see RefState",
    "verify/dataflow.py:RefState.write": "see RefState",
    "verify/dataflow.py:RefState.reset_run": "see RefState",
    "verify/dataflow.py:AnalyzerGap": "raised where the jaxpr interpreter "
        "meets an unmodeled primitive; the port reports an "
        "'analyzer-gap' violation instead",
    "launch/roofline.py:count_pallas_launches": "counts pallas_call in a "
        "jaxpr; the port's counterpart is count_kernel_launches",
    "launch/roofline.py:parse_collectives": "parses XLA HLO text; the "
        "port's counterpart is collective_link_bytes",
    "launch/roofline.py:ICI_BW": "the TPU v5e inter-chip link rate; the "
        "port's links are NVLINK_BW and NET_BW",
    "models/base.py:init_params": "a functional parameter tree; the "
        "port's counterpart is Model.init(generator)",
    "models/hybrid.py:init_cache": "a functional cache tree; the port's "
        "counterpart is Model.init_cache",
}


def _ref_modules():
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _public(name):
    return not any(part.startswith("_") for part in name.split("."))


def _ref_names(rel):
    """Public top-level names (and public class methods) of a reference
    module, from its source: jax need not run for the walk."""
    tree = ast.parse((REF / rel).read_text())
    init = rel.endswith("__init__.py")
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            names.update(f"{node.name}.{m.name}" for m in node.body
                         if isinstance(m, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)))
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif init and isinstance(node, ast.ImportFrom) and node.level:
            names.update(a.asname or a.name for a in node.names)
    return sorted(n for n in names if _public(n) and n != "__all__")


def _ref_all(rel):
    for node in ast.parse((REF / rel).read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def _port_module(rel):
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(["repro_torch", *parts])


def _has(obj, dotted):
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


@pytest.mark.parametrize("rel", _ref_modules())
def test_every_public_name_has_a_counterpart(rel):
    names = _ref_names(rel)
    mirror = pathlib.Path(ROOT / "src" / "repro_torch" / rel)
    if rel in NO_COUNTERPART:
        assert not mirror.exists(), f"{rel} now has a mirror: drop its entry"
        return
    assert mirror.exists(), f"the port has no {rel}"
    port = importlib.import_module(_port_module(rel))
    missing, stale = [], []
    for name in names:
        excused = f"{rel}:{name}" in NO_COUNTERPART
        if _has(port, name) == excused:
            (stale if excused else missing).append(name)
    assert not missing, f"{rel}: no counterpart for {missing}"
    assert not stale, f"{rel}: {stale} now have counterparts"


def test_no_counterpart_entries_name_reference_names():
    modules = set(_ref_modules())
    for key, why in NO_COUNTERPART.items():
        assert why
        rel, _, name = key.partition(":")
        assert rel in modules, key
        if name:
            assert name in _ref_names(rel), key


PACKAGES = [rel for rel in _ref_modules()
            if rel.endswith("__init__.py") and _ref_all(rel) is not None]


@pytest.fixture(scope="module")
def port_exports():
    """Each port package's ``__all__`` and missing attributes, read in a
    fresh interpreter (no submodule imported beforehand)."""
    code = ("import importlib, json, sys\n"
            "out = {}\n"
            "for mod, names in json.loads(sys.argv[1]).items():\n"
            "    m = importlib.import_module(mod)\n"
            "    out[mod] = [list(getattr(m, '__all__', [])),\n"
            "                [n for n in names if not hasattr(m, n)]]\n"
            "print(json.dumps(out))\n")
    want = {_port_module(rel): _ref_all(rel) for rel in PACKAGES}
    run = subprocess.run(
        [sys.executable, "-c", code, json.dumps(want)],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.splitlines()[-1])


@pytest.mark.parametrize("rel", PACKAGES)
def test_package_exports_match_the_reference(port_exports, rel):
    port_all, unbound = port_exports[_port_module(rel)]
    want = [n for n in _ref_all(rel) if f"{rel}:{n}" not in NO_COUNTERPART]
    assert not [n for n in want if n not in port_all], rel
    assert not [n for n in want if n in unbound], rel


# ------------------------------------------------------- the names added

NAMES = RR.names()
BATCH = 21


@pytest.fixture(scope="module")
def reference():
    """The reference's one-shot products and reports for every registry
    plan (its jaxpr dataflow gate patched out, as the designs tests do)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(repro.verify, "assert_plan_dataflow", lambda *a, **k: None)
        for name in NAMES:
            spec = RR.get(name)
            plan = RC._plan_with_timing(spec)[0]
            rng = np.random.default_rng(len(name))
            a = RL.random_limbs(rng, (BATCH,), spec.bits_a)
            b = RL.random_limbs(rng, (BATCH,), spec.bits_b)
            prod = np.asarray(RB.execute(plan, jnp.asarray(a),
                                         jnp.asarray(b)))
            reports = {be: RB.last_report(plan, jnp.asarray(a),
                                          jnp.asarray(b), backend=be)
                       for be in RB.BACKENDS}
            out[name] = (a, b, prod, reports)
    return out


def _report_fields(rep):
    return (rep.batch, rep.cycles, tuple(
        (dataclasses.asdict(i.config), i.n_ops, i.busy_cycles)
        for i in rep.instances), rep.plan_throughput,
        rep.working_set_bytes, rep.scheduler, tuple(rep.latency_hist))


@functools.lru_cache(maxsize=None)
def _port_plan(name):
    return TD.generate(name, device="cpu").plan


#: the kernel capability is unsigned-only (as the reference's)
CASES = [(n, be) for n in NAMES for be in TB.BACKENDS
         if not (be == "kernel" and RR.get(n).signed)]


@pytest.mark.parametrize("name, backend", CASES)
def test_one_shot_execute_equals_the_reference(reference, name, backend):
    a, b, want, reports = reference[name]
    ta, tb = TL.from_numpy(a, "cpu"), TL.from_numpy(b, "cpu")
    plan = _port_plan(name)
    got = TB.execute(plan, ta, tb, backend=backend)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))
    rep = TB.last_report(plan, ta, tb, backend=backend)
    assert _report_fields(rep) == _report_fields(reports[backend])
    # one cached bank per (plan, widths, backend, scheduler, device): the
    # one that ran, whose last report is the one-shot report
    bank = TB.engine._operand_bank(plan, ta, tb, backend, "round_robin")
    assert bank is TB.engine._operand_bank(plan, ta, tb, backend,
                                           "round_robin")
    assert _report_fields(bank.last_report) == _report_fields(rep)


def test_one_shot_execute_runs_on_the_operands_device():
    plan = _port_plan("tp3p5_w32")
    a = torch.ones((4, 2), dtype=torch.int32)
    assert TB.execute(plan, a, a).device == a.device
    bank = TB.engine._operand_bank(plan, a, a, "core", "round_robin")
    assert bank.device == torch.device("cpu") and bank.la == 2


#: (bits, throughput, signed): a mixed bank, a 128-bit folded one, and a
#: signed one (the fused path's shared correction pass)
EMPTY = [(32, Fraction(7, 2), False), (128, Fraction(5, 6), False),
         (32, Fraction(7, 2), True)]


@pytest.mark.parametrize("backend", TB.BACKENDS)
@pytest.mark.parametrize("bits, tp, signed", EMPTY)
def test_an_empty_round_returns_the_empty_product(bits, tp, signed,
                                                  backend):
    """(0, LA+LB) int32 on every backend, equal to "core" and to the
    reference's "core" bank, with no launch declared or counted."""
    if backend == "kernel" and signed:
        backend = "fused"          # the kernel capability is unsigned-only
    plan = TD.generate(TD.DesignSpec(bits, bits, tp, signed=signed),
                       device="cpu").plan
    bank = TB.Bank(plan, bits, bits, backend=backend, device="cpu")
    za = torch.zeros((0, bank.la), dtype=torch.int32)
    out = bank.execute(za, za)
    core = TB.Bank(plan, bits, bits, device="cpu").execute(za, za)
    assert out.dtype == torch.int32 and out.shape == (0, 2 * bank.la)
    assert torch.equal(out, core)
    assert bank.launch_count(0) == 0
    assert TDF.round_contract(bits, bits, plan.configs, 0) is None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(repro.verify, "assert_plan_dataflow", lambda *a, **k: None)
        rplan = RC._plan_with_timing(RS.DesignSpec(bits, bits, tp,
                                                   signed=signed))[0]
    ref = RB.Bank(rplan, bits, bits, backend="core").execute(
        jnp.zeros((0, bank.la), RL.LIMB_DTYPE),
        jnp.zeros((0, bank.la), RL.LIMB_DTYPE))
    assert tuple(ref.shape) == tuple(out.shape)


def test_backends_is_the_capability_tuple():
    assert TB.BACKENDS == TB.CAPABILITIES == tuple(RB.BACKENDS)
    assert TB.backends.BACKENDS is TB.BACKENDS


@pytest.mark.parametrize("la, lb", [(1, 1), (2, 8), (8, 2), (16, 16)])
def test_ppm_op_count_equals_the_reference(la, lb):
    assert TL.ppm_op_count(la, lb) == RL.ppm_op_count(la, lb) == la * lb


def test_matches_idle_equals_the_reference():
    """Both packages' ``matches_idle`` on a fused launch's declared idle
    steps, and on patterns with a wildcard."""
    configs = _port_plan("tp3p5_w32").configs
    flat = [cfg for count, cfg in configs for _ in range(count)]
    contract = bank_fold.launch_contract(flat, 2, 2)
    assert contract.idle_steps
    steps = [(i, j) for i in range(len(flat)) for j in range(3)]
    ref = types.SimpleNamespace(idle_steps=contract.idle_steps)
    for step in steps:
        assert contract.matches_idle(step) == \
            RI.LaunchContract.matches_idle(ref, step)
    wild = dataclasses.replace(contract, idle_steps=((None, 1),))
    ref.idle_steps = wild.idle_steps
    for step in steps:
        assert wild.matches_idle(step) == \
            RI.LaunchContract.matches_idle(ref, step) == (step[1] == 1)


def test_launch_exports_the_mesh_helpers():
    from repro_torch.launch import mesh
    assert TLA.make_production_mesh is mesh.make_production_mesh
    assert TLA.make_host_mesh is mesh.make_host_mesh
    assert TLA.data_axes is mesh.data_axes
    with pytest.raises(RuntimeError, match="process group"):
        TLA.make_host_mesh(1, "cpu")


def test_kernel_subpackages_import_with_the_package():
    code = ("import repro_torch.kernels as K\n"
            "for n in ('mcim_fold', 'bank_fold', 'int8_matmul', "
            "'karatsuba_ppm', 'prefix_adder'):\n"
            "    assert hasattr(K, n), n\n"
            "from repro_torch.core import sharded_execute\n"
            "from repro_torch.core.bank import execute, last_report\n")
    run = subprocess.run([sys.executable, "-c", code],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
