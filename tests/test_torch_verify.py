"""The port's plan gate (``repro_torch.verify``) held against the reference.

Interval reports and violations are compared field for field, the
violations by their ``describe()`` strings, over a seeded subset of the
(widths, MCIMConfig) space: bits in {1, 4, 8, 17, 33, 64, 129, 256,
300}, every valid arch, ct in {1, 2, 3, 5, 8, 16, 40}, levels 1-6, both
adders, signed and unsigned.  The refusing cases of ``test_verify.py``
refuse in both packages with the same strings, and the port's
``generate()``/``compile_plan()`` refuse where the reference's do.
The reference's ``generate()`` runs with its jaxpr dataflow gate
patched out (the jax of some environments cannot complete it); its
``assert_plan`` gate, the one the port copies, stays on.
"""
import dataclasses
from fractions import Fraction

import numpy as np
import pytest

import repro.verify as RV
from repro.core import planner as RP
from repro.core.mcim import MCIMConfig as RCfg
from repro.designs import DesignSpec as RSpec
from repro.designs import compile as RC
from repro.designs import registry as RR
from repro.kernels.mcim_fold import fold_geometry as r_fold_geometry
from repro_torch import designs as TD
from repro_torch import verify as TV
from repro_torch.core import limbs as TL
from repro_torch.core import planner as TP
from repro_torch.core.mcim import MCIMConfig as TCfg
from repro_torch.kernels.mcim_fold import fold_geometry
from repro_torch.verify import contracts as TCo
from repro_torch.verify import intervals as TI

WIDTHS = (1, 4, 8, 17, 33, 64, 129, 256, 300)
CTS = (1, 2, 3, 5, 8, 16, 40)
SUBSTRATES = ("core", "kernel", "fused")
N_POINTS = 120


def _valid_configs():
    out = []
    for arch in ("star", "fb", "ff", "karatsuba"):
        for ct in CTS:
            for levels in range(1, 7):
                for adder in ("1ca", "3ca"):
                    for signed in (False, True):
                        kw = dict(arch=arch, ct=ct, levels=levels,
                                  adder=adder, signed=signed)
                        try:
                            TCfg(**kw)
                        except ValueError:
                            continue
                        out.append(kw)
    return out


def _points():
    rng = np.random.default_rng(20231017)
    cfgs = _valid_configs()
    out = []
    for _ in range(N_POINTS):
        ba, bb = (int(x) for x in rng.choice(WIDTHS, size=2))
        out.append((ba, bb, cfgs[int(rng.integers(len(cfgs)))]))
    return out


POINTS = _points()


def _ids(point):
    ba, bb, kw = point
    return (f"{ba}x{bb}-{kw['arch']}-ct{kw['ct']}-k{kw['levels']}-"
            f"{kw['adder']}{'-s' if kw['signed'] else ''}")


def _fields(rep):
    d = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)}
    d["config"] = dataclasses.asdict(rep.config)
    d["violations"] = [v.describe() for v in rep.violations]
    return d


def _described(violations):
    return [v.describe() for v in violations]


@pytest.fixture
def ref_generate(monkeypatch):
    """The reference's generate(), its dataflow gate patched out."""
    monkeypatch.setattr(RV, "assert_plan_dataflow", lambda *a, **k: None)
    return RC.generate


@pytest.fixture
def narrow_lanes(monkeypatch):
    """Both analyzers with 18-bit lanes: a seeded counterexample under
    which wide designs provably overflow and the gates must refuse."""
    for mod in (RV.intervals, TI):
        monkeypatch.setattr(mod, "U32_MAX", (1 << 18) - 1)
    RV.verify_instance.cache_clear()
    TV.verify_instance.cache_clear()
    yield
    RV.verify_instance.cache_clear()
    TV.verify_instance.cache_clear()


# ----------------------------------------------------- interval parity

@pytest.mark.parametrize("point", POINTS, ids=_ids)
def test_interval_reports_match_reference(point):
    ba, bb, kw = point
    for sub in SUBSTRATES:
        want = RV.intervals.analyze(ba, bb, RCfg(**kw), substrate=sub)
        got = TI.analyze(ba, bb, TCfg(**kw), substrate=sub)
        assert _fields(got) == _fields(want), sub
        assert got.describe() == want.describe()
    assert _described(TV.verify_instance(ba, bb, TCfg(**kw))) == \
        _described(RV.verify_instance(ba, bb, RCfg(**kw)))


@pytest.mark.parametrize("point", POINTS[:60], ids=_ids)
def test_row_tile_columns_are_the_fused_walks(point):
    """The CUDA row tiles' uint32 columns (tiles::schoolbook) are bounded
    exactly as the fused walk bounds them: bank_fold with the window
    weights, FB/FF/star with weight 1 (star's fused walk)."""
    ba, bb, kw = point
    cfg = TCfg(**kw)
    got = TI.analyze_row_tiles(ba, bb, cfg, "fused")
    want = TI.analyze(ba, bb, cfg, substrate="fused")
    assert (got.ok, got.max_column, got.headroom_bits) == \
        (want.ok, want.max_column, want.headroom_bits)
    assert got.ok and got.max_column <= TL.U32_MAX
    if cfg.arch == "karatsuba":
        with pytest.raises(ValueError):
            TI.analyze_row_tiles(ba, bb, cfg, "kernel")
        return
    star = TCfg(arch="star", ct=1, signed=cfg.signed)
    kern = TI.analyze_row_tiles(ba, bb, cfg, "kernel")
    assert kern.max_column == TI.analyze(ba, bb, star, "fused").max_column
    assert kern.ok


def test_row_tile_walk_sees_an_overflow(narrow_lanes):
    rep = TI.analyze_row_tiles(256, 256, TCfg(arch="fb", ct=2), "kernel")
    assert not rep.ok
    assert all(v.rule == "u32-overflow" for v in rep.violations)


@pytest.mark.parametrize("seed", range(6))
def test_plan_violations_match_reference(seed):
    """Two-instance plans, with the true throughput and a wrong one."""
    rng = np.random.default_rng(seed)
    cfgs = [kw for kw in _valid_configs() if not kw["signed"]]
    for _ in range(8):
        ba, bb = (int(x) for x in rng.choice(WIDTHS[:7], size=2))
        picks = [cfgs[int(rng.integers(len(cfgs)))] for _ in range(2)]
        counts = [int(rng.integers(1, 3)) for _ in picks]
        tp = sum(Fraction(c, kw["ct"]) for c, kw in zip(counts, picks))
        for claim in (tp, tp + Fraction(1, 7)):
            want = RV.verify_plan(ba, bb, [(c, RCfg(**kw)) for c, kw
                                           in zip(counts, picks)], claim)
            got = TV.verify_plan(ba, bb, [(c, TCfg(**kw)) for c, kw
                                          in zip(counts, picks)], claim)
            assert _described(got) == _described(want)
            if claim != tp:
                assert any(v.rule == "throughput-sum" for v in got)


# ------------------------------------------- seeded counterexamples

def _cases(V, Cfg, fold_geo):
    """The refusing cases of test_verify.py, for one package."""
    fb2 = Cfg(arch="fb", ct=2)
    geo = fold_geo(2, 2, 2, "fb")
    ctx = V.intervals._Ctx()
    huge = [TL.U32_MAX] * 4
    V.intervals.compress_bounds([(huge, 0), (huge, 0)], 4, ctx, "seeded")
    req = V.intervals.required_scratch_width(32, 32, fb2)
    return {
        "scratch-too-narrow": V.contracts.check_widths(
            32, 32, fb2, scratch_width=req - 1),
        "out-width": V.contracts.check_widths(32, 32, fb2, out_width=3),
        "double-cover": V.contracts.check_coverage(
            32, 32, fb2, windows=(geo.b_windows[0],
                                  (geo.b_windows[1][0] - 1,
                                   geo.b_windows[1][1]))),
        "missing-product": V.contracts.check_coverage(
            64, 64, fb2,
            windows=fold_geo(4, 4, 2, "fb").b_windows[:-1]),
        "u32-overflow": ctx.violations,
        "throughput-sum": V.contracts.check_throughput(
            ((1, Cfg(arch="star", ct=1)), (1, fb2)), Fraction(7, 4)),
        "fused-double-cover": V.contracts.check_fused_schedule(
            32, 32, fb2, windows=((0, 2), (1, 2))),
        "fused-scratch-too-narrow": V.contracts.check_fused_widths(
            32, 32, fb2, scratch_width=3),
        "fused-empty-bank": V.contracts.check_fused_plan(32, 32, ()),
    }


CASES = tuple(_cases(TV, TCfg, fold_geometry))


@pytest.mark.parametrize("case", CASES)
def test_seeded_counterexamples_refuse_in_both(case):
    want = _cases(RV, RCfg, r_fold_geometry)[case]
    got = _cases(TV, TCfg, fold_geometry)[case]
    assert got, case
    assert _described(got) == _described(want)


def test_assert_plan_raises_with_the_reference_violations():
    with pytest.raises(RV.VerificationError) as want:
        RV.assert_plan(32, 32, ((1, RCfg(arch="fb", ct=2)),),
                       Fraction(1, 3))
    with pytest.raises(TV.VerificationError) as got:
        TV.assert_plan(32, 32, ((1, TCfg(arch="fb", ct=2)),),
                       Fraction(1, 3))
    assert str(got.value) == str(want.value)
    assert any(v.rule == "throughput-sum" for v in got.value.violations)


def test_scheduler_contract_rejects_incomplete_assignment():
    @dataclasses.dataclass(frozen=True)
    class DropsLastOp:
        name: str = "drops_last"

        def schedule(self, cts, n_ops):
            ops = tuple(range(max(n_ops - 1, 0)))
            return (ops,) + ((),) * (len(cts) - 1), len(ops) * cts[0]

    got = TCo.check_scheduler(DropsLastOp(), (1, 2), 5)
    want = RV.contracts.check_scheduler(DropsLastOp(), (1, 2), 5)
    assert any(v.rule == "scheduler-coverage" for v in got)
    assert _described(got) == _described(want)


# ------------------------------------------------- plan-time gating

@pytest.mark.parametrize("name", RR.names())
def test_registry_designs_prove_safe_as_in_reference(name, ref_generate):
    d = TD.generate(name, device="cpu")
    assert TV.verify_design(d) == ()
    assert RV.verify_design(ref_generate(name)) == ()


def _refusal(VerificationError, fn, *args, **kw):
    """The violations a gate raised, as strings; () when it passed."""
    try:
        fn(*args, **kw)
    except VerificationError as e:
        return tuple(_described(e.violations))
    return ()


@pytest.mark.parametrize("name", RR.names())
def test_generate_refuses_where_reference_refuses(name, ref_generate,
                                                  narrow_lanes):
    want = _refusal(RV.VerificationError, ref_generate, name)
    got = _refusal(TV.VerificationError, TD.generate, name, device="cpu")
    assert got == want
    if RR.get(name).bits_a >= 128:
        assert got      # 18-bit lanes hold no 128-bit schoolbook column


@pytest.mark.parametrize("bits,tp", [(8, "1/2"), (32, "5/6"),
                                     (128, "7/2"), (256, "1/3")])
def test_compile_plan_refuses_where_reference_refuses(bits, tp,
                                                      ref_generate,
                                                      narrow_lanes):
    spec = RSpec(bits, bits, Fraction(tp))
    plan = RP.plan_throughput(bits, bits, Fraction(tp))
    configs = [(c, dataclasses.asdict(cfg)) for c, cfg in plan.configs]
    want = _refusal(RV.VerificationError, RC.compile_plan, spec,
                    [(c, RCfg(**kw)) for c, kw in configs])
    tspec = TD.DesignSpec.from_json(spec.to_json())
    got = _refusal(TV.VerificationError, TD.compile_plan, tspec,
                   [(c, TCfg(**kw)) for c, kw in configs], device="cpu")
    assert got == want
    assert (bits >= 128) == bool(got)


def test_generate_and_compile_plan_call_the_gate(monkeypatch):
    calls = []
    real = TV.assert_plan

    def spy(bits_a, bits_b, configs, throughput=None):
        calls.append((bits_a, bits_b, tuple(configs), throughput))
        return real(bits_a, bits_b, configs, throughput)

    monkeypatch.setattr(TV, "assert_plan", spy)
    d = TD.generate(TD.DesignSpec(32, 32, Fraction(1, 2)), device="cpu")
    assert calls[-1] == (32, 32, d.plan.configs, d.plan.throughput)
    TD.compile_plan(TD.DesignSpec(16, 16, Fraction(1, 2)),
                    [(1, TCfg(arch="ff", ct=2))], device="cpu")
    assert len(calls) == 2 and calls[-1][:2] == (16, 16)


# ------------------------------------------- port copies of test_verify

@pytest.mark.parametrize("arch,ct,levels,adder", [
    ("star", 1, 1, "1ca"),
    ("fb", 2, 1, "1ca"), ("fb", 12, 1, "1ca"),
    ("ff", 2, 1, "1ca"), ("ff", 6, 1, "1ca"),
    ("karatsuba", 3, 1, "1ca"), ("karatsuba", 3, 3, "3ca"),
])
@pytest.mark.parametrize("bits", [8, 32, 128])
def test_vocabulary_proves_safe_on_both_substrates(arch, ct, levels,
                                                   adder, bits):
    cfg = TCfg(arch=arch, ct=ct, levels=levels, adder=adder)
    for substrate in ("core", "kernel"):
        rep = TI.analyze(bits, bits, cfg, substrate=substrate)
        assert rep.ok, rep.violations
        assert rep.headroom_bits > 0
        assert rep.max_column <= TL.U32_MAX


def test_required_width_matches_kernel_geometry():
    for bits in (8, 32, 64, 128):
        la = lb = TL.n_limbs_for_bits(bits)
        for ct in (2, 3, 4, 6, 8, 12):
            for arch in ("fb", "ff"):
                cfg = TCfg(arch=arch, ct=ct)
                req = TI.required_scratch_width(bits, bits, cfg)
                assert req <= fold_geometry(la, lb, ct, arch).scratch_width
        req = TI.required_scratch_width(bits, bits,
                                        TCfg(arch="karatsuba", ct=3))
        assert req <= fold_geometry(la, lb, 3, "karatsuba").scratch_width


def test_signed_wrapper_proves_safe():
    assert TV.verify_instance(32, 32, TCfg(arch="fb", ct=2,
                                           signed=True)) == ()


@pytest.mark.parametrize("backend", ["core", "kernel", "fused"])
@pytest.mark.parametrize("tp", ["7/2", "5/6", "1/3"])
def test_bank_dispatch_is_static(backend, tp):
    plan = TP.plan_throughput(32, 32, Fraction(tp))
    assert TCo.check_bank_static(plan, 32, 32, backend=backend) == []


@pytest.mark.parametrize("backend", ["core", "kernel", "fused"])
@pytest.mark.parametrize("tp", ["7/2", "5/6", "1/3"])
def test_bank_dispatch_runs_on_fake_tensors(backend, tp, monkeypatch):
    """The dispatch check feeds the concrete closure fake operands (no
    data): what it proves holds for any operand values."""
    from torch._subclasses.fake_tensor import FakeTensor
    from repro_torch.core.bank import Bank
    seen = []
    real = Bank.dispatch_fn

    def spy(self, batch):
        run = real(self, batch)

        def wrapped(a, b):
            out = run(a, b)
            seen.append((type(a), type(out), tuple(out.shape)))
            return out
        return wrapped
    monkeypatch.setattr(Bank, "dispatch_fn", spy)
    plan = TP.plan_throughput(32, 32, Fraction(tp))
    assert TCo.check_bank_static(plan, 32, 32, backend=backend,
                                 batch=40) == []
    assert seen == [(FakeTensor, FakeTensor, (40, 4))]


def test_bank_dispatch_reading_an_operand_value_is_not_traceable(
        monkeypatch):
    """A dispatch that branches on an operand's value (the data-dependent
    route the reference's eval_shape refuses) is ``bank-not-traceable``,
    with the reference's wording."""
    from repro_torch.core.bank import Bank
    real = Bank.dispatch_fn

    def branching(self, batch):
        run = real(self, batch)

        def wrapped(a, b):
            if (a[:, -1] > 0x7FFF).any():       # a sign-dependent route
                return run(b, a)
            return run(a, b)
        return wrapped
    monkeypatch.setattr(Bank, "dispatch_fn", branching)
    plan = TP.plan_throughput(32, 32, Fraction(7, 2))
    for backend in ("core", "kernel", "fused"):
        got = TCo.check_bank_static(plan, 32, 32, backend=backend)
        assert [v.rule for v in got] == ["bank-not-traceable"]
        assert "operand-value dependence or tracer leak" in got[0].detail
        assert "DataDependentOutputException" in got[0].detail


def test_custom_ops_fake_versions_give_the_kernels_outputs():
    """Each kernel's custom op, called under ``FakeTensorMode``, gives
    its kernel's output shape and dtype from the input shapes alone
    (and launches nothing)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import (_build, bank_fold, int8_matmul,
                                     karatsuba_ppm, mcim_fold, prefix_adder)
    before = _build.launch_counts()
    i32, i64, i8 = torch.int32, torch.int64, torch.int8
    with FakeTensorMode():
        def e(*shape, dtype=i32):
            return torch.empty(shape, dtype=dtype)
        cases = [
            (bank_fold.fused_bank_mul_kernel(e(120, 2), e(120, 5),
                                             e(120), e(3, 2, 2),
                                             path="auto"),
             (120, 7), i32),
            (mcim_fold.mcim_fold_kernel(e(33, 4), e(33, 4), schedule="ff",
                                        path="bulk"), (33, 8), i32),
            (mcim_fold.mcim_fold_karatsuba_kernel(e(9, 3), e(9, 5)),
             (9, 8), i32),
            (prefix_adder.prefix_adder_kernel(e(17, 12, dtype=i64)),
             (17, 12), i32),
            (karatsuba_ppm.karatsuba_ppm_kernel(e(5, 6), e(5, 6),
                                                path="auto"), (5, 12), i32),
            (int8_matmul.int8_matmul_kernel(
                e(7, 32, dtype=i8), e(32, 48, dtype=i8),
                e(7, dtype=torch.float32), e(48, dtype=torch.float32),
                path="auto"), (7, 48), torch.bfloat16),
            (int8_matmul.int8_matmul_kernel(
                e(7, 32, dtype=i8), e(32, 48, dtype=i8),
                e(7, dtype=torch.float32), e(48, dtype=torch.float32),
                path="mma_sync", out_dtype=torch.float32), (7, 48),
             torch.float32),
        ]
    for out, shape, dtype in cases:
        assert tuple(out.shape) == shape and out.dtype == dtype
    assert _build.launch_counts() == before
    for name in ("fused_bank_mul_kernel", "mcim_fold_kernel",
                 "mcim_fold_karatsuba_kernel", "prefix_adder_kernel",
                 "karatsuba_ppm_kernel", "int8_matmul_kernel"):
        assert hasattr(torch.ops.repro_torch, name)
