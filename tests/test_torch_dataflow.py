"""The port's plan-time dataflow gate (``repro_torch.verify.dataflow``).

The reference analyzes traced Pallas jaxprs, which some jax versions
cannot complete (its ``analyze_plan`` reports an ``analyzer-gap``), so
the port's launch reports are not held against the reference's.  What
is held against the reference: ``check_window_table`` (pure numpy in
both) on the reference's seeded corruptions, rule names and ``where``
strings included; the rule names, ``RAGGED_BATCHES`` and the plan-level
API.  The roofline is held to ``PERF.md`` section 6's bounds at
``chip_smoke.py`` phase 2's shapes, the launch mirrors to the H100's
own ``*_launch_shape`` figures (occupancy from the card), and every
seeded contract fault must be refused by its rule.
"""
import dataclasses
import itertools
import json

import numpy as np
import pytest

from repro.core.mcim import MCIMConfig as RCfg
from repro.kernels import bank_fold as RB
from repro.verify import dataflow as RD
from repro_torch import designs as TD
from repro_torch import verify as TV
from repro_torch.core.mcim import MCIMConfig as TCfg
from repro_torch.kernels import (_row_tiles, bank_fold, int8_matmul,
                                 introspect, karatsuba_ppm, mcim_fold,
                                 prefix_adder)
from repro_torch.verify import dataflow as TDF

ARCHS = (("fb", 1), ("fb", 2), ("karatsuba", 3))


def _rules(violations):
    return {v.rule for v in violations}


def _described(violations):
    return [v.describe() for v in violations]


def _geos(cfgs=(("fb", 1), ("fb", 2)), la=2, lb=2):
    return (RB.super_geometry([RCfg(arch=a, ct=c) for a, c in cfgs], la, lb),
            bank_fold.super_geometry([TCfg(arch=a, ct=c) for a, c in cfgs],
                                     la, lb))


@pytest.fixture(autouse=True)
def fresh_caches():
    TDF.clear_caches()
    yield
    TDF.clear_caches()


# ------------------------------------------- window tables, as the reference

def _both(corrupt, cfgs=(("fb", 1), ("fb", 2)), la=2, lb=2):
    """The reference's and the port's findings on one corrupted table."""
    rsg, tsg = _geos(cfgs, la, lb)
    assert np.array_equal(rsg.table(), tsg.table())
    tbl = corrupt(tsg.table().copy())
    want = RD.check_window_table(rsg, tbl)
    got = TDF.check_window_table(tsg, tbl)
    assert _described(got) == _described(want)
    return got


def _set(i, j, k, delta=None, value=None):
    def corrupt(tbl):
        if value is not None:
            tbl[i, j] = value
        else:
            tbl[i, j, k] += delta
        return tbl
    return corrupt


def test_window_off_by_one_hi_rejected():
    vs = _both(_set(1, 1, 1, delta=1))
    hits = [v for v in vs if v.rule == "window-bounds"]
    assert hits and "instance 1 step 1" in hits[0].where


def test_window_overlap_rejected():
    assert "window-overlap" in _rules(_both(_set(1, 1, 0, delta=-1)))


def test_window_coverage_gap_rejected():
    assert {"window-empty", "window-coverage"} <= _rules(
        _both(_set(1, 1, None, value=(0, 0))))


def test_unmasked_idle_rejected_by_table_and_contract():
    """An idle step carrying a real window: the table rule, and the
    kernel's limb weights (``idle-step-effect``) name the (instance,
    step) pair."""
    assert "idle-unmasked" in _rules(_both(_set(0, 1, None, value=(0, 2))))
    cfgs = (TCfg(arch="fb", ct=1), TCfg(arch="fb", ct=2))
    tbl = bank_fold.super_geometry(cfgs, 2, 2).table()
    tbl[0, 1] = (0, 2)
    rep = TDF.analyze_contract(bank_fold.launch_contract(cfgs, 2, 2,
                                                         table=tbl))
    hits = [v for v in rep.violations if v.rule == "idle-step-effect"]
    assert hits and "step (0, 1)" in hits[0].where
    assert "[0, 1]" in hits[0].detail


def test_window_shape_mismatch_rejected():
    assert "window-shape" in _rules(
        _both(lambda tbl: np.zeros((1, 1, 2), np.int32)))


def _corruptions(sg, good):
    for i, j, k in itertools.product(range(sg.n_instances),
                                     range(sg.max_steps), range(2)):
        for val in range(-2, sg.lb + 3):
            tbl = good.copy()
            tbl[i, j, k] = val
            yield tbl


def test_exhaustive_single_cell_corruptions_match_the_reference():
    """Every single-cell change of a three-instance table is rejected,
    every no-op rewrite passes, with the reference's findings."""
    cfgs = (("fb", 1), ("fb", 2), ("karatsuba", 3))
    rsg, tsg = _geos(cfgs, 4, 4)
    good = tsg.table()
    assert not TDF.check_window_table(tsg, good)
    for tbl in _corruptions(tsg, good):
        got = TDF.check_window_table(tsg, tbl)
        assert _described(got) == _described(
            RD.check_window_table(rsg, tbl))
        assert bool(got) != np.array_equal(tbl, good)


def test_seeded_random_corruptions_match_the_reference():
    """Multi-cell corruptions drawn from a seed (the hypothesis sweep's
    deterministic edition)."""
    rng = np.random.default_rng(20231017)
    cfgs = (("fb", 1), ("fb", 2), ("ff", 3), ("karatsuba", 3))
    rsg, tsg = _geos(cfgs, 8, 8)
    good = tsg.table()
    for _ in range(300):
        tbl = good.copy()
        cells = rng.integers(0, tbl.size, size=int(rng.integers(1, 4)))
        tbl.reshape(-1)[cells] = rng.integers(-2, 11, size=cells.size)
        got = TDF.check_window_table(tsg, tbl)
        assert _described(got) == _described(
            RD.check_window_table(rsg, tbl))
        assert bool(got) != np.array_equal(tbl, good)


def test_hypothesis_random_corruptions_rejected():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    rsg, tsg = _geos(ARCHS, 4, 4)
    good = tsg.table()

    @hyp.given(st.integers(0, tsg.n_instances - 1),
               st.integers(0, tsg.max_steps - 1), st.integers(0, 1),
               st.integers(-2, tsg.lb + 2))
    @hyp.settings(max_examples=120, deadline=None)
    def prop(i, j, k, val):
        tbl = good.copy()
        tbl[i, j, k] = val
        got = TDF.check_window_table(tsg, tbl)
        assert _described(got) == _described(
            RD.check_window_table(rsg, tbl))
        assert bool(got) != np.array_equal(tbl, good)

    prop()


# ------------------------------------------------- seeded contract faults

def _fused(la=2, lb=2, rows=64):
    cfgs = (TCfg(arch="star", ct=1),) * 3 + (TCfg(arch="fb", ct=2),)
    return bank_fold.launch_contract(cfgs, la, lb, rows=rows)


def test_grid_mismatch_rejected():
    c = mcim_fold.launch_contract(2, 2, 2, batch=513)
    assert c.path == "per_thread" and TDF.analyze_contract(c).ok
    bad = dataclasses.replace(c, grid=(c.grid[0] + 1, 1))
    assert _rules(TDF.analyze_contract(bad).violations) == {"grid-mismatch"}
    bad = dataclasses.replace(c, smem_bytes=c.smem_bytes + 16)
    assert "grid-mismatch" in _rules(TDF.analyze_contract(bad).violations)


def test_understated_smem_model_and_budget_rejected():
    c = mcim_fold.launch_contract(8, 8, 2, batch=1024)
    assert c.path == "bulk" and c.smem_bytes == c.smem_model_bytes == 32784
    bad = dataclasses.replace(c, smem_model_bytes=c.smem_bytes - 16)
    assert _rules(TDF.analyze_contract(bad).violations) == {"smem-model"}
    assert _rules(TDF.analyze_contract(c, budget=32768).violations) == {
        "smem-budget"}
    assert TDF.analyze_contract(c, budget=32784).ok


def test_out_of_bounds_span_rejected():
    c = karatsuba_ppm.launch_contract(4, batch=300)
    ops = dict(c.operands)
    ops["a"] = introspect.Operand((299, 4), "int32")
    rep = TDF.analyze_contract(dataclasses.replace(c, operands=ops))
    assert _rules(rep.violations) == {"block-bounds"}
    assert "a[256:300, 0:4]" in rep.violations[0].detail


def test_bulk_copy_off_sixteen_bytes_rejected():
    """A bulk tile whose spans are not whole 16-byte units."""
    c = mcim_fold.launch_contract(2, 2, 2, batch=1024)
    assert c.path == "bulk"
    bad = dataclasses.replace(c, meta={**c.meta, "tile_rows": 511})
    rep = TDF.analyze_contract(bad)
    assert "block-bounds" in _rules(rep.violations)
    assert "16-byte" in next(v.detail for v in rep.violations
                             if v.rule == "block-bounds")


def test_row_written_twice_and_unwritten_rejected(monkeypatch):
    c = mcim_fold.launch_contract(3, 3, 2, batch=300)
    walk = introspect._WALKS["tiles"]
    extra = introspect.BlockWork((9, 0), (), (("out", (0, 1), (0, 6)),))
    monkeypatch.setitem(introspect._WALKS, "tiles",
                        lambda k: itertools.chain(walk(k), [extra]))
    rep = TDF.analyze_contract(c)
    assert _rules(rep.violations) == {"waw"}
    assert "row 0" in rep.violations[0].where
    monkeypatch.setitem(introspect._WALKS, "tiles",
                        lambda k: itertools.islice(walk(k), 2))
    rep = TDF.analyze_contract(c)
    assert _rules(rep.violations) == {"unwritten-row"}
    assert "row 256" in rep.violations[0].where


def _with_owner(c, owner):
    return TDF.analyze_contract(dataclasses.replace(
        c, meta={**c.meta, "owner": owner}))


def test_owner_table_faults_rejected():
    """Planted faults in the fused dispatch's owner table, each refused
    by its named rule: an owner out of range, an instance owning one op
    too many, two ops of different instances swapping owners."""
    c = _fused()
    assert TDF.analyze_contract(c).ok
    owner, assign = c.meta["owner"], c.meta["assign"]
    assert owner.dtype == np.int32 and owner.shape == (c.meta["batch"],)
    assert np.bincount(owner).tolist() == list(c.meta["n_ops"])
    bad = owner.copy()
    bad[5] = 4                                   # 4 instances: 0-3
    rep = _with_owner(c, bad)
    assert "owner-bounds" in _rules(rep.violations)
    assert "first op 5 (owner 4)" in next(
        v.detail for v in rep.violations if v.rule == "owner-bounds")
    bad = owner.copy()
    bad[-1] = -1
    assert "owner-bounds" in _rules(_with_owner(c, bad).violations)
    star, fb = assign[0][0], assign[3][0]        # ops of instances 0, 3
    bad = owner.copy()
    bad[fb] = 0                                  # instance 0: one too many
    rep = _with_owner(c, bad)
    assert _rules(rep.violations) == {"owner-count", "owner-map"}
    counts = [v for v in rep.violations if v.rule == "owner-count"]
    assert [v.where.split()[-1] for v in counts] == ["0", "3"]
    n0 = c.meta["n_ops"][0]
    assert f"owns {n0 + 1} ops, its assignment {n0}" in counts[0].detail
    bad = owner.copy()
    bad[[star, fb]] = bad[[fb, star]]            # two ops swap owners
    rep = _with_owner(c, bad)
    assert _rules(rep.violations) == {"owner-map"}
    assert len(rep.violations) == 2
    assert f"first op {star} by instance 3" in rep.violations[0].detail
    rep = _with_owner(c, owner[:-1])
    assert _rules(rep.violations) == {"owner-bounds"}


def test_unknown_launcher_and_wide_rows_are_findings():
    c = mcim_fold.launch_contract(2, 2, 2)
    for bad in (dataclasses.replace(c, kernel="mcim_fold_tma_launch"),
                dataclasses.replace(c, path="tma")):
        assert _rules(TDF.analyze_contract(bad).violations) == {
            "analyzer-gap"}
    over = TDF.MAX_LIMBS + 1          # one limb past the kernels' widest
    wide = mcim_fold.launch_contract(over, over, 2)
    assert _rules(TDF.analyze_contract(wide).violations) == {
        "launch-width"}
    assert _rules(TDF.analyze_contract(
        prefix_adder.launch_contract(65)).violations) == {"launch-width"}


# ------------------------------------------------------- clean launches

@pytest.mark.parametrize("name", TD.names())
def test_registry_plans_prove_clean_on_both_substrates(name):
    d = TD.generate(name, device="cpu")
    for substrate in ("kernel", "fused"):
        for rep in TDF.analyze_plan(d.spec.bits_a, d.spec.bits_b,
                                    d.plan.configs, substrate=substrate):
            assert rep.ok, (substrate, _described(rep.violations))
            assert rep.flops > 0 and rep.hbm_bytes > 0
            assert rep.arith_intensity > 0 and rep.bound_ms > 0


def test_vocabulary_clean_at_one_width():
    vocab = [TCfg(arch="star", ct=1), TCfg(arch="karatsuba", ct=3)]
    vocab += [TCfg(arch=a, ct=ct) for a in ("fb", "ff")
              for ct in (2, 3, 12)]
    for cfg in vocab:
        assert TDF.verify_plan_dataflow(32, 32, ((1, cfg),)) == (), cfg


def test_signed_configs_analyze_like_unsigned():
    cfg = TCfg(arch="fb", ct=2)
    signed = dataclasses.replace(cfg, signed=True)
    for substrate in ("kernel", "fused"):
        assert TDF.analyze_plan(32, 32, ((1, cfg),), substrate) == \
            TDF.analyze_plan(32, 32, ((1, signed),), substrate)


def test_ragged_batches_take_both_paths_and_prove_clean():
    assert TDF.RAGGED_BATCHES == RD.RAGGED_BATCHES
    reps = TDF.analyze_tiling()
    assert all(r.ok for r in reps), [_described(r.violations) for r in reps]
    paths = {b: r.path for b, r in zip(TDF.RAGGED_BATCHES, reps)}
    assert paths[513] == paths[977] == "per_thread"
    assert paths[8] == paths[100] == paths[512] == "bulk"


def test_standalone_contracts_prove_clean():
    reps = TDF.analyze_standalone()
    assert [r.kernel for r in reps] == ["karatsuba_ppm_launch",
                                        "prefix_adder_launch",
                                        "int8_matmul_launch"]
    for rep in reps:
        assert rep.ok, (rep.name, _described(rep.violations))
        assert rep.arith_intensity > 0
    assert reps[2].path == "wgmma_prefill"


def test_report_serializes():
    rep = TDF.analyze_plan(32, 32, ((1, TCfg(arch="star", ct=1)),))[0]
    d = rep.as_dict()
    assert d["ok"] and d["violations"] == []
    json.dumps(d)


def test_reports_are_cached_per_geometry():
    a = TDF.analyze_plan(32, 32, ((1, TCfg(arch="fb", ct=2)),))
    b = TDF.analyze_plan(32, 32, ((1, TCfg(arch="fb", ct=2)),))
    assert a[0] is b[0]


# ------------------------------------------------------ roofline, mirrors

@pytest.mark.parametrize("name,want_bytes,want_ms", [
    ("tp3p5_w32", 37_748_736, 0.0113),        # PERF.md section 6
    ("tp5over6_w128", 138_412_032, 0.0413)])
def test_plan_static_stats_give_the_fused_rounds_bytes(name, want_bytes,
                                                       want_ms):
    """``chip_smoke.py`` phase 2's fused rounds (B = 1,048,576): operands
    and the owner table read once, products written once, the window
    table left out."""
    d = TD.generate(name, device="cpu")
    stats = TDF.plan_static_stats(d.spec.bits_a, d.spec.bits_b,
                                  d.plan.configs, batch=1 << 20)
    assert stats["ok"] and stats["hbm_bytes_per_launch"] == want_bytes
    assert stats["bound_by"] == "bytes"
    assert round(stats["bound_ms"], 4) == want_ms
    gate = TDF.plan_static_stats(d.spec.bits_a, d.spec.bits_b,
                                 d.plan.configs)
    assert gate["ok"] and gate["hbm_bytes_per_launch"] < want_bytes


def test_round_contract_owner_is_the_dispatch_owner():
    """The contract declares the launch the dispatch makes: the round's
    rows in batch order, ``fused_owner`` of the design's assignment (one
    construction), ops over the instances' real rows."""
    from repro_torch.core.bank.schedule import get_scheduler
    d = TD.generate("tp3p5_w32", device="cpu")
    batch = 1 << 20
    c = TDF.round_contract(32, 32, d.plan.configs, batch)
    n_ops = [i.n_ops for i in d.report(batch).instances]
    assert c.meta["n_ops"] == tuple(n_ops) and c.meta["rows"] == batch
    assign, _ = get_scheduler(d.spec.scheduler).schedule(
        tuple(cfg.ct for cfg in d.bank.instances), batch)
    np.testing.assert_array_equal(c.meta["owner"],
                                  bank_fold.fused_owner(assign, batch))
    assert c.operands["a"].shape == (batch, 2)
    assert c.operands["owner"].shape == (batch,)
    assert c.outputs["out"].shape == (batch, 4)
    assert c.launch_args == (4, batch, 2, 2, 2) and c.path == "bulk"
    per_row = [introspect.ops_per_row("bank_fold", 2, 2, windows)
               for windows in (((0, 2), (0, 0)), ((0, 1), (1, 2)))]
    assert c.meta["ops"] == (sum(n_ops[:3]) * per_row[0]
                             + n_ops[3] * per_row[1])


@pytest.mark.parametrize("kernel,args,want", [
    # the H100's own *_launch_shape figures (132 SMs; 8, 4, 2, 2 blocks
    # an SM at 2, 4, 8, 16 limbs)
    # (bank_fold's bulk blocks keep an instance's L weights after them)
    ("bank_fold_bulk_launch", (1, 1 << 22, 2, 2, 2), ((1056, 1), 256, 16408)),
    ("bank_fold_bulk_launch", (3, 1 << 22, 4, 4, 2), ((528, 1), 256, 49232)),
    ("mcim_fold_bulk_launch", (1 << 22, 8, 8), ((264, 1), 128, 32784)),
    ("mcim_fold_bulk_launch", (1 << 22, 16, 16), ((264, 1), 128, 65552)),
    ("karatsuba_ppm_bulk_launch", (1 << 22, 2), ((1056, 1), 256, 16400)),
    ("bank_fold_launch", (3, 1000, 3, 3, 2), ((8, 1), 128, 3584)),
    ("mcim_fold_launch", (1000, 2, 2), ((8, 1), 128, 0)),
    ("mcim_fold_karatsuba_launch", (1000, 6, 6), ((8, 1), 128, 6656)),
    ("karatsuba_ppm_launch", (1000, 16), ((8, 1), 128, 16896)),
    ("prefix_adder_launch", (1000, 16), ((63, 1), 256, 0)),
    ("prefix_adder_launch", (1000, 64), ((125, 1), 256, 0)),
    ("int8_matmul_launch", (2048, 3584, 14336, 1, 0), ((16, 112), 256, 0)),
    ("int8_matmul_launch", (2048, 3584, 14336, 1, 1),
     ((32, 224), 256, 99424)),
    ("int8_matmul_launch", (2048, 3584, 14336, 1, 2),
     ((16, 56), 384, 197696)),
])
def test_launch_mirror_matches_the_cards_launch_shape(kernel, args, want):
    assert introspect.launch_shape(kernel, args) == want


def test_launch_mirror_refuses_what_the_launchers_refuse():
    for kernel, args in (("bank_fold_bulk_launch", (1, 7, 2, 2, 1)),
                         ("bank_fold_bulk_launch", (129, 1024, 2, 2, 1)),
                         ("mcim_fold_bulk_launch", (128, 3, 5)),
                         ("karatsuba_ppm_bulk_launch", (128, 4)),
                         ("karatsuba_ppm_launch", (128, 3)),
                         ("int8_matmul_launch", (64, 100, 64, 1, 1))):
        with pytest.raises(ValueError):
            introspect.launch_shape(kernel, args)
    with pytest.raises(KeyError):
        introspect.launch_shape("nope_launch", ())


def test_per_thread_walk_is_the_tile_walk_one_tile_a_block():
    c = bank_fold.launch_contract((TCfg(arch="fb", ct=2),) * 3, 3, 3,
                                  rows=600)
    assert c.path == "per_thread"
    n_tiles, n_y = c.grid
    assert n_y == 1                   # the round's rows in batch order
    walk = _row_tiles.tile_walk(c.meta["rows"], c.block, n_tiles)
    blocks = {w.block: w for w in c.blocks()}
    for t, tiles in enumerate(walk):
        (row0, n), = tiles
        work = blocks[(t, 0)]
        assert work.writes == (("out", (row0, row0 + n), (0, 6)),)
        assert ("owner", (0, 1), (row0, row0 + n)) in work.reads


@pytest.mark.parametrize("scheduler", ["round_robin", "greedy"])
@pytest.mark.parametrize("la", [1, 2, 3, 4, 8, 16, 24])
def test_fused_dispatch_owner_is_the_assignment(la, scheduler):
    """``make_fused_dispatch`` launches on the caller's rows with
    ``fused_owner``'s table: every op owned by the instance its
    assignment names; products equal the integer oracle on ragged and
    prime batches (CPU, plain path), and nothing is copied."""
    import torch
    from repro_torch import telemetry
    from repro_torch.core import limbs as TL
    from repro_torch.core.bank.schedule import get_scheduler
    cfgs = (TCfg(arch="star", ct=1), TCfg(arch="fb", ct=2),
            TCfg(arch="ff", ct=3))
    rng = np.random.default_rng(la)
    for batch in (37, 100, 1):
        assign, _ = get_scheduler(scheduler).schedule(
            tuple(c.ct for c in cfgs), batch)
        owner = bank_fold.fused_owner(assign, batch)
        assert owner.dtype == np.int32 and owner.shape == (batch,)
        for i, ops in enumerate(assign):
            assert (owner[list(ops)] == i).all()
        assert np.bincount(owner, minlength=3).tolist() == [
            len(ops) for ops in assign]
        a = TL.from_numpy(TL.random_limbs(rng, (batch,), 16 * la), "cpu")
        b = TL.from_numpy(TL.random_limbs(rng, (batch,), 16 * la), "cpu")
        run = bank_fold.make_fused_dispatch(assign, cfgs, la, la, batch,
                                            device="cpu")
        before = telemetry.totals()["counters"]["bank_fold.operand_copies"]
        want = [int(x) * int(y) for x, y in zip(TL.batch_from_limbs(a),
                                                TL.batch_from_limbs(b))]
        assert TL.batch_from_limbs(run(a, b)) == want
        assert torch.equal(run(a, b), run(a, b))
        assert telemetry.totals()["counters"][
            "bank_fold.operand_copies"] == before


def test_fused_dispatch_copies_views_that_are_not_contiguous():
    """A transposed operand is copied once a call and counted as
    ``bank_fold.operand_copies``; a contiguous one is taken as it is."""
    import torch
    from repro_torch import telemetry
    from repro_torch.core import limbs as TL
    from repro_torch.core.bank.schedule import round_robin_schedule
    cfgs = (TCfg(arch="star", ct=1), TCfg(arch="fb", ct=2))
    batch, la = 29, 4
    assign, _ = round_robin_schedule((1, 2), batch)
    run = bank_fold.make_fused_dispatch(assign, cfgs, la, la, batch,
                                        device="cpu")
    rng = np.random.default_rng(3)
    a = TL.from_numpy(TL.random_limbs(rng, (batch,), 16 * la), "cpu")
    b = TL.from_numpy(TL.random_limbs(rng, (batch,), 16 * la), "cpu")
    a_t = a.t().contiguous().t()              # the same values, transposed
    assert not a_t.is_contiguous()

    def copies():
        return telemetry.totals()["counters"]["bank_fold.operand_copies"]

    before = copies()
    want = run(a, b)
    assert copies() == before
    assert torch.equal(run(a_t, b), want)
    assert copies() == before + 1


# ------------------------------------------------------- the plan gate

def test_generate_and_compile_plan_call_the_gate(monkeypatch):
    calls = []
    real = TV.assert_plan_dataflow

    def spy(bits_a, bits_b, configs, budget=None):
        calls.append((bits_a, bits_b, tuple(configs)))
        return real(bits_a, bits_b, configs, budget)

    monkeypatch.setattr(TV, "assert_plan_dataflow", spy)
    d = TD.generate("tp3p5_w32", device="cpu")
    assert calls[-1] == (32, 32, d.plan.configs)
    TD.compile_plan(TD.DesignSpec(16, 16, d.plan.throughput / 7),
                    [(1, TCfg(arch="ff", ct=2))], device="cpu")
    assert len(calls) == 2 and calls[-1][:2] == (16, 16)


def test_bad_window_refused_before_a_bank_is_built(monkeypatch):
    """One window of the super-geometry one limb past LB (its windows
    and the table built from them agreeing, so ``assert_plan`` passes):
    ``generate`` raises ``DataflowError`` and builds no Bank."""
    from repro_torch.designs import compile as TC
    from repro_torch.kernels.bank_fold import geometry
    real = geometry.SuperGeometry.windows

    def bad(self, i):
        wins = real(self, i)
        return ((wins[0][0], self.lb + 1),) + wins[1:] if i == 0 else wins

    def no_bank(*a, **k):
        raise AssertionError("a Bank was built")
    monkeypatch.setattr(geometry.SuperGeometry, "windows", bad)
    monkeypatch.setattr(TC, "Bank", no_bank)
    TDF.clear_caches()
    with pytest.raises(TV.DataflowError) as e:
        TD.generate("tp3p5_w32", device="cpu")
    assert "window-bounds" in _rules(e.value.violations)
    assert isinstance(e.value, TV.VerificationError)
