"""The 381-bit cell (``tp5over6_w381.bulk``): the reference at 24 limbs,
the three readers it adds (the ``bank_fold`` kernel's device time and its
share of the round's bound, and the program's wide-launch counter) on
records with known values, and whole CPU runs of the cell at a small
size: a sound one comes out correct, the control not."""
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness, reference, roofline
from repro_torch import telemetry

CELL = "tp5over6_w381.bulk"
BENCH = harness.load_benchmark()
SMALL = {"batch": 2048, "pool_bytes": 40_000, "sample_rows": 64}
SEED = 2**31 + 381
COUNTER = "launch.bank_fold.wide"


def _limbs(values, n=24):
    return torch.tensor([[(v >> (16 * k)) & 0xFFFF for k in range(n)]
                         for v in values], dtype=torch.int32)


def _ints(limbs):
    return [sum(int(x) << (16 * k) for k, x in enumerate(row))
            for row in limbs.tolist()]


@pytest.mark.parametrize("seed", (1, 2))
def test_reference_equals_python_bigints_at_24_limbs(seed):
    rng = np.random.default_rng(seed)
    top = (1 << 381) - 1
    xs = [int(v) for v in rng.integers(0, 1 << 62, 300)]
    xs = [x << int(rng.integers(0, 319)) for x in xs] + [0, 1, top]
    ys = xs[::-1]
    got = reference.mul_limbs(_limbs(xs), _limbs(ys))
    assert got.shape == (len(xs), 48)
    assert _ints(got) == [x * y for x, y in zip(xs, ys)]


def _device(ops, n_calls):
    return SimpleNamespace(top_ops=lambda n=10: ops[:n] if n else ops,
                           n_calls=n_calls)


def _record(device=None, calls=(), bound_s=None):
    return harness.Record(setup_s=0.0, calls=list(calls), spans=None,
                          device=device, bound_s=bound_s)


OPS = [["void at::native::vectorized_gather_kernel<16, long>", 0.050],
       ["void bank_fold_bulk_kernel<24>", 0.002],
       ["void at::native::index_elementwise_kernel<128, 4>", 0.010],
       ["void bank_fold_kernel<24>", 0.001]]


def test_fold_kernel_ms_sums_the_bank_fold_operations_alone():
    read = harness.load_reader("fold_kernel_ms.bulk")
    assert read(_record(_device(OPS, 10))) == pytest.approx(0.3)
    assert read(_record(_device(OPS[:1], 10))) is None
    assert read(_record()) is None


def test_fold_kernel_share_is_of_the_24_limb_round_bound():
    bound = roofline.round_bound_s(1 << 20, 24, 24)
    assert bound == pytest.approx(1.2018e-4, rel=1e-3)       # bytes bind
    assert roofline.round_ops(1 << 20, 24, 24) / roofline.INT32_OPS_PER_S \
        < bound / 3
    read = harness.load_reader("fold_kernel_roofline_pct.bulk")
    # 0.003 s over 10 calls: 0.3 ms a call
    assert read(_record(_device(OPS, 10), bound_s=bound)) == pytest.approx(
        100 * bound / 3e-4)
    assert read(_record(_device(OPS[:1], 10), bound_s=bound)) is None


def _window(wide_per_call):
    """A warm-up call that counts 1,000 wide launches, then three timed
    calls that count ``wide_per_call`` each."""
    with telemetry.root("design.mul"):
        telemetry.count(COUNTER, 1000)
    calls = []
    for _ in range(3):
        t0 = time.perf_counter()
        with telemetry.root("design.mul"):
            telemetry.count(COUNTER, wide_per_call)
        calls.append((t0, time.perf_counter(), 1))
    return _record(calls=calls)


def test_wide_launches_reads_the_programs_counter_a_call():
    read = harness.load_reader("wide_launches.bulk")
    assert read(_window(1)) == 1.0
    assert read(_window(0)) == 0.0


def test_wide_launches_reads_nothing_without_the_counter(monkeypatch):
    rec = _window(1)
    calls = telemetry.calls

    def without(t0, t1):
        return [dataclasses.replace(c, counters={
                    k: v for k, v in c.counters.items() if k != COUNTER})
                for c in calls(t0, t1)]

    monkeypatch.setattr(telemetry, "calls", without)
    assert harness.load_reader("wide_launches.bulk")(rec) is None


def _run(control=False):
    return harness.run_cell(BENCH, CELL, SEED, 0.3, False,
                            t_start=time.perf_counter(), device="cpu",
                            mix_override=SMALL, control=control)


def test_cell_resolves_to_the_381_bit_design():
    work, config, mix = harness.resolve(BENCH, CELL)
    assert config["operand_limbs"] == [24, 24]
    assert (config["spec"]["bits_a"], config["spec"]["bits_b"]) == (381, 381)
    assert mix["batch"] == 1 << 20 and work["chips"] == 1
    # one slot of 2**20 pairs of 24-limb operands: 192 MiB, 4x the L2
    assert -(-mix["pool_bytes"] // (mix["batch"] * 48 * 4)) == 1


def test_small_run_is_correct_and_its_control_is_not():
    res = _run()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert all(v == 0 for v, _ in res["checks"].values())
    res = _run(control=True)
    assert not res["correct"]
    assert res["checks"]["calls_fingerprint_differs"][0] == \
        res["record"].n_calls
