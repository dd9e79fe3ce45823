"""The benchmark's yardstick on the CPU: the plain reference, the frozen
work count, and the frozen traffic copies."""
import numpy as np
import pytest
import torch

from portbench import generator, reference, roofline


def _limbs(values, n):
    return torch.tensor([[(v >> (16 * i)) & 0xFFFF for i in range(n)]
                         for v in values], dtype=torch.int32)


def _ints(limbs):
    return [sum(int(x) << (16 * i) for i, x in enumerate(row))
            for row in limbs.tolist()]


@pytest.mark.parametrize("bits", [32, 128])
def test_reference_equals_python_bigints(bits):
    rng = np.random.default_rng(bits)
    top = (1 << bits) - 1
    a = [top, 0, 1, top] + [int(x) for x in
                            rng.integers(0, 1 << 62, 60)] * (bits // 64 + 1)
    b = [top, top, top, 1] + [int(x) for x in
                              rng.integers(0, 1 << 62, 60)] * (bits // 64 + 1)
    a = [x & top for x in a]
    b = [(x * 0x9E3779B97F4A7C15) & top for x in b]
    n = bits // 16
    got = reference.mul_limbs(_limbs(a, n), _limbs(b, n))
    assert got.shape == (len(a), 2 * n)
    assert _ints(got) == [x * y for x, y in zip(a, b)]


@pytest.mark.parametrize("bits", [32, 128])
def test_control_comes_out_wrong(bits):
    """The int32-column control wraps: most random products differ."""
    n = bits // 16
    gen = torch.Generator().manual_seed(bits)
    a = torch.randint(0, 1 << 16, (256, n), generator=gen, dtype=torch.int32)
    b = torch.randint(0, 1 << 16, (256, n), generator=gen, dtype=torch.int32)
    exact = reference.mul_limbs(a, b)
    control = reference.mul_limbs(a, b, acc_dtype=torch.int32)
    assert (control != exact).any(1).float().mean() > 0.4


def test_reference_blocks_agree():
    gen = torch.Generator().manual_seed(3)
    a = torch.randint(0, 1 << 16, (1000, 8), generator=gen, dtype=torch.int32)
    b = torch.randint(0, 1 << 16, (1000, 8), generator=gen, dtype=torch.int32)
    whole = reference.mul_limbs(a, b)
    old = reference.BLOCK_ROWS
    try:
        reference.BLOCK_ROWS = 97
        assert torch.equal(reference.mul_limbs(a, b), whole)
    finally:
        reference.BLOCK_ROWS = old


@pytest.mark.parametrize("la, nbytes, ms", [(2, 33_554_432, 0.0100),
                                            (8, 134_217_728, 0.0401)])
def test_fixed_work_count(la, nbytes, ms):
    batch = 1_048_576
    assert roofline.round_bytes(batch, la, la) == nbytes
    assert roofline.round_ops(batch, la, la) == batch * la * la
    assert round(roofline.round_bound_s(batch, la, la) * 1e3, 4) == ms


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_frozen_arrivals_equal_the_programs(seed):
    from repro_torch.serving import poisson_arrivals
    assert generator.poisson_arrivals(300, 2.45, seed) == \
        poisson_arrivals(300, 2.45, seed)


@pytest.mark.parametrize("bits", [32, 128])
def test_frozen_synthesize_equals_the_programs(bits):
    from repro_torch.serving import synthesize
    arrivals = generator.poisson_arrivals(200, 0.6, 11)
    theirs = synthesize(arrivals, bits, bits, budget=9, seed=12)
    ours = generator.synthesize(arrivals, bits, bits, 9, seed=12)
    assert [(r.rid, r.arrival, r.deadline, r.a, r.b) for r in theirs] == \
        list(ours)


def _serve_mix(**kw):
    return {"requests": 40, "traces": 4, "load": 0.8,
            "budget_ct_factor": 4, "budget_cycles_per_tp": 32,
            "shape_seed": 5, **kw}


def test_every_seed_serves_the_same_arrivals():
    one = generator.serve_traces(_serve_mix(), 32, 32, 3.5, 2, 1)
    two = generator.serve_traces(_serve_mix(), 32, 32, 3.5, 2, 2**31 + 9)
    arrivals = lambda traces: sorted(tuple(r[1] for r in t) for t in traces)
    assert arrivals(one) == arrivals(two)
    assert [r[3] for t in one for r in t] != [r[3] for t in two for r in t]
    assert one == generator.serve_traces(_serve_mix(), 32, 32, 3.5, 2, 1)
    assert all(r[2] - r[1] == 10 for t in one for r in t)


@pytest.mark.parametrize("tp, max_ct, budget", [(3.5, 2, 10),
                                                (5 / 6, 3, 39)])
def test_budget_is_the_serving_benchmarks(tp, max_ct, budget):
    """max(4 x max CT, ceil(32 / TP)): 10 and 39 cycles for the cells."""
    mix = _serve_mix()
    assert generator.budget_cycles(mix, tp, max_ct) == budget


def test_operand_pool_is_seeded_and_covers_the_l2():
    mix = {"batch": 1000, "pool_bytes": 100_000}
    a, b = generator.operand_pool(mix, 32, 128, 2**31 + 1, "cpu")
    assert a.shape == (3, 1000, 2) and b.shape == (3, 1000, 8)
    assert a.dtype == torch.int32 and int(a.max()) < 1 << 16
    assert int(a.min()) >= 0
    a2, _ = generator.operand_pool(mix, 32, 128, 2**31 + 1, "cpu")
    assert torch.equal(a, a2)
    assert not torch.equal(a[0], a[1])
    odd, _ = generator.operand_pool(mix, 20, 20, 3, "cpu")
    assert int(odd[..., 1].max()) < 1 << 4
