"""The port's replicated banks (``core.bank.sharded``) against the JAX
reference, on the CPU.

The port's mesh axis is a list of devices; ``["cpu"] * N`` stands for
the reference's N-device placeholder CPU mesh.  Products are compared as
integers (tolerance 0) with the reference's single bank, with its
``sharded_execute`` on a 2-device mesh (run in a subprocess, since the
device count is set before jax is imported) and with the Python-bigint
oracle, on the three plans of ``tests/test_sharded_bank.py``.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import limbs as RL
from repro.core import planner as RPL
from repro.core import bank as RB
from repro_torch.core import limbs as TL
from repro_torch.core import planner as TPL
from repro_torch.core.bank import Bank, sharded_execute, sharded_report
from repro_torch.core.bank import sharded as TS

SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")
BATCH = 28

#: TP=7/2 (star+fb), TP=5/6 at 128 bits (fb+karatsuba), strict 1/2 (ff)
PLANS = {
    "tp3p5_w32": (32, Fraction(7, 2), False),
    "tp5over6_w128": (128, Fraction(5, 6), False),
    "strict_half_w64": (64, Fraction(1, 2), True),
}
BACKENDS = ("core", "kernel")
SCHEDULERS = ("round_robin", "greedy")
#: the reference's sharded_execute on a 2-device mesh: every plan on core
#: with both schedulers, and the kernel capability on the first plan
MESH_CASES = ([(p, "core", s) for p in PLANS for s in SCHEDULERS]
              + [("tp3p5_w32", "kernel", "round_robin")])

REFERENCE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from fractions import Fraction
import numpy as np
import jax, jax.numpy as jnp
from repro.core import planner, bank

plans, cases, out = (json.loads(sys.argv[1]), json.loads(sys.argv[2]),
                     sys.argv[3])
meshes = {n: jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("data",))
          for n in (2, 4)}
ops = dict(np.load(out + ".in.npz"))


def plan_of(name):
    bits, num, den, strict = plans[name]
    return planner.plan_throughput(bits, bits, Fraction(num, den),
                                   strict_timing=strict)


res, meta = {}, {"reports": {}, "errors": {}}
for name, backend, sched in cases:
    a, b = (jnp.asarray(ops[f"{name}_{x}"]) for x in "ab")
    res[f"{name}-{backend}-{sched}"] = np.asarray(bank.sharded_execute(
        plan_of(name), a, b, meshes[2], "data", backend=backend,
        scheduler=sched))
for name, (bits, *_) in plans.items():
    for n, mesh in meshes.items():
        rep = bank.sharded_report(plan_of(name), 28, bits, bits, mesh, "data")
        meta["reports"][f"{name}-{n}"] = {
            "batch": rep.batch, "cycles": rep.cycles,
            "plan_throughput": str(rep.plan_throughput),
            "working_set_bytes": rep.working_set_bytes,
            "scheduler": rep.scheduler,
            "latency_hist": [list(x) for x in rep.latency_hist],
            "instances": [[dataclasses.asdict(i.config), i.n_ops,
                           i.busy_cycles] for i in rep.instances]}
plan = plan_of("tp3p5_w32")
a, b = (jnp.asarray(ops[f"tp3p5_w32_{x}"]) for x in "ab")
for label, args in (("ragged", (a[:27], b[:27])), ("one_d", (a[0], b[0])),
                    ("mismatch", (a, b[:26]))):
    try:
        bank.sharded_execute(plan, *args, meshes[2], "data")
    except ValueError as e:
        meta["errors"][label] = str(e)
np.savez(out, **res)
with open(out + ".json", "w") as f:
    json.dump(meta, f)
"""


def _port_plan(name):
    bits, tp, strict = PLANS[name]
    return TPL.plan_throughput(bits, bits, tp, strict_timing=strict)


def _ref_plan(name):
    bits, tp, strict = PLANS[name]
    return RPL.plan_throughput(bits, bits, tp, strict_timing=strict)


@functools.lru_cache(maxsize=None)
def _operands(name):
    bits = PLANS[name][0]
    rng = np.random.default_rng(len(name))
    return (RL.random_limbs(rng, (BATCH,), bits),
            RL.random_limbs(rng, (BATCH,), bits))


@functools.lru_cache(maxsize=None)
def _reference_single_bank(name, backend, sched):
    a, b = _operands(name)
    return np.asarray(RB.execute(_ref_plan(name), jnp.asarray(a),
                                 jnp.asarray(b), backend=backend,
                                 scheduler=sched)).astype(np.int32)


def _oracle(name):
    a, b = _operands(name)
    return [RL.from_limbs(x) * RL.from_limbs(y) for x, y in zip(a, b)]


def _cpu(x):
    return TL.from_numpy(x, "cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's mesh results: products, reports and messages."""
    out = str(tmp_path_factory.mktemp("sharded") / "ref")
    np.savez(out + ".in.npz", **{f"{n}_{x}": _operands(n)[i]
                                 for n in PLANS
                                 for i, x in enumerate("ab")})
    plans = {n: (bits, tp.numerator, tp.denominator, strict)
             for n, (bits, tp, strict) in PLANS.items()}
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, json.dumps(plans),
         json.dumps(MESH_CASES), out],
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out + ".json") as f:
        return dict(np.load(out + ".npz")), json.load(f)


@pytest.mark.parametrize("name", PLANS)
def test_plans_match_reference(name):
    assert _port_plan(name).describe() == _ref_plan(name).describe()


@pytest.mark.parametrize("n_dev", (2, 4))
@pytest.mark.parametrize("sched", SCHEDULERS)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", PLANS)
def test_sharded_execute_matches_reference_single_bank(name, backend, sched,
                                                       n_dev):
    a, b = _operands(name)
    plan = _port_plan(name)
    got = sharded_execute(plan, _cpu(a), _cpu(b), ["cpu"] * n_dev,
                          backend=backend, scheduler=sched)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  _reference_single_bank(name, backend, sched))
    single = Bank(plan, PLANS[name][0], PLANS[name][0], backend=backend,
                  scheduler=sched, device="cpu").execute(_cpu(a), _cpu(b))
    assert torch.equal(got, single)
    assert TL.batch_from_limbs(got) == _oracle(name)


@pytest.mark.parametrize("name,backend,sched", MESH_CASES)
def test_sharded_execute_matches_reference_mesh(reference, name, backend,
                                                sched):
    a, b = _operands(name)
    got = sharded_execute(_port_plan(name), _cpu(a), _cpu(b), ["cpu"] * 2,
                          backend=backend, scheduler=sched)
    want = reference[0][f"{name}-{backend}-{sched}"]
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("n_dev", (2, 4))
@pytest.mark.parametrize("name", PLANS)
def test_sharded_report_matches_reference(reference, name, n_dev):
    bits = PLANS[name][0]
    rep = sharded_report(_port_plan(name), BATCH, bits, bits, ["cpu"] * n_dev)
    want = reference[1]["reports"][f"{name}-{n_dev}"]
    got = {"batch": rep.batch, "cycles": rep.cycles,
           "plan_throughput": str(rep.plan_throughput),
           "working_set_bytes": rep.working_set_bytes,
           "scheduler": rep.scheduler,
           "latency_hist": [list(x) for x in rep.latency_hist],
           "instances": [[dataclasses.asdict(i.config), i.n_ops,
                          i.busy_cycles] for i in rep.instances]}
    assert got == want
    assert rep.batch == BATCH // n_dev
    assert sum(i.n_ops for i in rep.instances) == BATCH // n_dev


def test_errors_match_reference_messages(reference):
    plan = _port_plan("tp3p5_w32")
    a, b = (_cpu(x) for x in _operands("tp3p5_w32"))
    want = reference[1]["errors"]
    for label, args in (("ragged", (a[:27], b[:27])), ("one_d", (a[0], b[0])),
                        ("mismatch", (a, b[:26]))):
        with pytest.raises(ValueError) as err:
            sharded_execute(plan, *args, ["cpu"] * 2)
        assert str(err.value) == want[label], label
    with pytest.raises(ValueError, match="has no devices"):
        sharded_execute(plan, a, b, [])
    with pytest.raises(ValueError, match="not divisible by mesh axis 'x'"):
        sharded_report(plan, 27, 32, 32, ["cpu"] * 2, axis="x")


def test_replica_banks_are_cached_per_device_and_shard():
    plan = _port_plan("tp3p5_w32")
    first = TS._replica_banks(plan, 32, 32, ["cpu"] * 2, 14)
    assert first[0] is first[1]                  # one device, repeated
    assert TS._replica_banks(plan, 32, 32, ["cpu"], 14)[0] is first[0]
    assert TS._replica_banks(plan, 32, 32, ["cpu"], 7)[0] is not first[0]
    other = TS._replica_banks(plan, 32, 32, ["cpu"], 14, backend="kernel")
    assert other[0].backend == "kernel" and other[0] is not first[0]

