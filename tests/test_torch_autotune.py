"""repro_torch.autotune: the reference's autotune tests on the port, and
fronts held string for string against the reference's.

``search(space).to_json()`` must be the same JSON in both packages for
every registry name and for mixed spaces: the same candidates, scores,
dominated-by provenance and space key.  The port's cache lives in its
own directory under its own variable, so a front the reference wrote is
never served to the port.
"""
import json
from fractions import Fraction

import pytest

import repro.autotune as RA
from repro.designs import DesignSpec as RSpec
from repro.designs import registry as RR
from repro_torch import autotune, designs
from repro_torch.autotune import (Candidate, ParetoFront, cache,
                                  ct_decompositions, enumerate_configs,
                                  pareto_front)
from repro_torch.core import power_model as pm
from repro_torch.core.mcim import MCIMConfig


def _spec(bits=32, tp=Fraction(1, 3), **kw):
    return designs.DesignSpec(bits, bits, tp, **kw)


# --------------------------------------------------- parity with the reference

MIXED = {
    "same_problem": ("tbl8_w32_relaxed", "tbl8_w32_strict",
                     "tbl8_w32_lowpower"),
    "cross_problem": ("tp3p5_w32", {"bits_a": 16, "bits_b": 16,
                                    "throughput": "5/6", "clock_ns": 0.4},
                      {"bits_a": 64, "bits_b": 64, "throughput": "1/2",
                       "signed": True}),
}


def _space(pkg_spec, items):
    return [s if isinstance(s, str) else pkg_spec(**s) for s in items]


@pytest.mark.parametrize("name", RR.names())
def test_registry_front_json_equals_reference(name, tmp_path):
    want = RA.search(name, cache_dir=str(tmp_path / "ref")).to_json()
    got = autotune.search(name, cache_dir=str(tmp_path / "port")).to_json()
    assert got == want
    assert json.loads(got)["front"]


@pytest.mark.parametrize("space", sorted(MIXED))
def test_mixed_space_front_json_equals_reference(space, tmp_path):
    items = MIXED[space]
    want = RA.search(_space(RSpec, items), cache_dir=str(tmp_path / "r"))
    got = autotune.search(_space(designs.DesignSpec, items),
                          cache_dir=str(tmp_path / "p"))
    assert got.to_json() == want.to_json()
    assert got.n_scored == want.n_scored > 0
    again = autotune.search(_space(designs.DesignSpec, items),
                            cache_dir=str(tmp_path / "p"))
    assert again.from_cache and again.n_scored == 0
    assert [c.to_dict() for c in again.front] == \
        [c.to_dict() for c in got.front]


def test_default_cache_directories_differ(monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    ref_dir = RA.cache_dir_path()
    port_dir = autotune.cache_dir_path()
    assert ref_dir != port_dir
    assert port_dir == str(tmp_path / ".cache" / "repro_torch_autotune")
    # the reference's variable does not move the port's cache
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref"))
    assert autotune.cache_dir_path() == port_dir
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "own"))
    assert autotune.cache_dir_path() == str(tmp_path / "own")


def test_port_never_reads_a_front_the_reference_wrote(monkeypatch,
                                                      tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    spec = RSpec(16, 16, Fraction(1, 2))
    ref = RA.search(spec)
    assert RA.search(spec).from_cache          # the reference's file
    port = autotune.search(designs.DesignSpec(16, 16, Fraction(1, 2)))
    assert not port.from_cache and port.n_scored == ref.n_scored
    assert port.space_key == ref.space_key     # same key, own directory


def test_space_key_hashes_the_reference_payload():
    for items in MIXED.values():
        assert autotune.space_key(
            [designs.get(s) if isinstance(s, str) else
             designs.DesignSpec(**s) for s in items]) == \
            RA.space_key([RR.get(s) if isinstance(s, str) else RSpec(**s)
                          for s in items])
    assert cache.AUTOTUNE_VERSION == RA.AUTOTUNE_VERSION
    assert pm.MODEL_VERSION == RA.cache.MODEL_VERSION


# ------------------------------------------- port copies of test_autotune

def test_ct_decompositions_exact_cover():
    for frac in (Fraction(1, 2), Fraction(1, 3), Fraction(5, 6),
                 Fraction(11, 12)):
        decs = ct_decompositions(frac)
        assert decs, f"no decomposition for {frac}"
        for cts in decs:
            assert sum(Fraction(1, ct) for ct in cts) == frac
            assert tuple(sorted(cts)) == cts
        assert decs == RA.ct_decompositions(frac)


def test_ct_decompositions_include_paper_combination():
    assert (2, 3) in ct_decompositions(Fraction(5, 6))


def test_enumerate_mixed_bank_has_star_base():
    for configs in enumerate_configs(_spec(tp=Fraction(7, 2))):
        (n, star), *rest = configs
        assert star.arch == "star" and n == 3
        assert sum(Fraction(c, cfg.ct) for c, cfg in rest) == Fraction(1, 2)


def test_enumerate_deduplicates_multisets():
    configs = enumerate_configs(_spec(tp=Fraction(2, 3)))
    keys = [tuple(sorted((c, cfg.arch, cfg.ct, cfg.levels, cfg.adder)
                         for c, cfg in cs)) for cs in configs]
    assert len(keys) == len(set(keys))


def test_enumerate_respects_clock_gate():
    for configs in enumerate_configs(_spec(clock_ns=0.31)):
        assert all(cfg.arch != "fb" for _, cfg in configs)
    assert any(cfg.arch == "fb"
               for configs in enumerate_configs(_spec())
               for _, cfg in configs)


def test_enumerate_strict_gate_matches_pipelineable():
    from repro_torch.core import timing_model
    for configs in enumerate_configs(_spec(strict_timing=True,
                                           clock_ns=0.31)):
        for _, cfg in configs:
            assert timing_model.pipelineable(cfg.arch, cfg.adder)


def _mk(key_tag, area, lat, fmax, e, p):
    return Candidate(spec=_spec(tp=Fraction(1, key_tag)), configs=(
        (1, MCIMConfig(arch="fb", ct=key_tag)),),
        area_um2=area, latency_cycles=lat, fmax_ghz=fmax,
        energy_per_op_pj=e, peak_power_mw=p, slack_ns=(0.0,))


def test_pareto_front_no_dominated_point():
    front = autotune.search(_spec(), use_cache=False)
    assert len(front) >= 2
    for a in front:
        for b in front:
            assert not a.dominates(b)


def test_pareto_dominated_have_provenance():
    front = autotune.search(_spec(), use_cache=False)
    assert front.dominated
    all_keys = {c.key for c in front} | {c.key for c in front.dominated}
    for c in front.dominated:
        assert c.dominated_by in all_keys
        assert c.dominated_by != c.key


def test_pareto_order_invariance():
    scored = [autotune.score(_spec(), cfgs)
              for cfgs in enumerate_configs(_spec())]
    f1, d1 = pareto_front(scored)
    f2, d2 = pareto_front(list(reversed(scored)))
    assert [c.key for c in f1] == [c.key for c in f2]
    assert [(c.key, c.dominated_by) for c in d1] == \
        [(c.key, c.dominated_by) for c in d2]


def test_domination_is_strict():
    a = _mk(2, 100, 2, 1.0, 1.0, 1.0)
    b = _mk(3, 100, 2, 1.0, 1.0, 1.0)
    assert not a.dominates(b) and not b.dominates(a)
    c = _mk(4, 90, 2, 1.0, 1.0, 1.0)
    assert c.dominates(a) and not a.dominates(c)


def test_best_per_objective():
    front = autotune.search(_spec(), use_cache=False)
    for obj, (attr, maximize) in autotune.OBJECTIVES.items():
        best = front.best(obj)
        vals = [getattr(c, attr) for c in front]
        assert getattr(best, attr) == (max(vals) if maximize else min(vals))
    with pytest.raises(ValueError):
        front.best("beauty")


def test_best_meeting_filters_on_throughput():
    front = autotune.search("tp3p5_w32", use_cache=False)
    assert front.best_meeting(3.5).spec.throughput == Fraction(7, 2)
    assert front.best_meeting(10.0) is None
    with pytest.raises(ValueError):
        front.best_meeting(0.1, objective="nope")


def test_scores_match_compiled_design():
    front = autotune.search(_spec(), use_cache=False)
    c = front.best("energy")
    d = c.compile(device="cpu")
    assert d.energy_per_op_pj == pytest.approx(c.energy_per_op_pj)
    assert d.peak_power_mw == pytest.approx(c.peak_power_mw)
    assert d.latency_cycles == c.latency_cycles
    assert d.area == pytest.approx(c.area_um2)
    assert d.device.type == "cpu"


def test_candidate_compiles_bit_exact():
    front = autotune.search(_spec(bits=16), use_cache=False)
    for c in list(front)[:3]:
        d = c.compile(device="cpu")
        assert d.mul(0xBEEF, 0xF00D) == 0xBEEF * 0xF00D


def test_slack_nonnegative_at_scoring_period():
    front = autotune.search(_spec(), use_cache=False)
    for c in list(front) + list(front.dominated):
        assert len(c.slack_ns) == len(c.configs)
        assert all(s >= 0 for s in c.slack_ns)
        assert min(c.slack_ns) == pytest.approx(0.0, abs=1e-5)


def test_tp_half_energy_savings_sign_all_widths():
    for bits in (8, 16, 32, 64, 128):
        front = autotune.search(_spec(bits=bits, tp=Fraction(1, 2)),
                                use_cache=False)
        star_e = pm.energy_per_op_pj(bits, bits, MCIMConfig(arch="star",
                                                            ct=1))
        assert front.best("energy").energy_per_op_pj < star_e * 0.9, bits


def test_cache_zero_rescores(tmp_path):
    spec = _spec()
    first = autotune.search(spec, cache_dir=str(tmp_path))
    assert not first.from_cache and first.n_scored > 0
    second = autotune.search(spec, cache_dir=str(tmp_path))
    assert second.from_cache and second.n_scored == 0
    assert [c.to_dict() for c in second.front] == \
        [c.to_dict() for c in first.front]


def test_cache_key_depends_on_spec_and_model():
    assert autotune.space_key([_spec()]) != \
        autotune.space_key([_spec(tp=Fraction(1, 2))])
    a, b = _spec(), _spec(tp=Fraction(1, 2))
    assert autotune.space_key([a, b]) == autotune.space_key([b, a])


def test_cache_corrupt_file_is_miss(tmp_path):
    spec = _spec()
    first = autotune.search(spec, cache_dir=str(tmp_path))
    for f in tmp_path.iterdir():
        f.write_text("{not json")
    again = autotune.search(spec, cache_dir=str(tmp_path))
    assert not again.from_cache and again.n_scored == first.n_scored


def test_front_serialization_round_trip():
    front = autotune.search(_spec(), use_cache=False)
    again = ParetoFront.from_json(front.to_json())
    assert [c.to_dict() for c in again.front] == \
        [c.to_dict() for c in front.front]
    assert [c.to_dict() for c in again.dominated] == \
        [c.to_dict() for c in front.dominated]
    assert json.loads(front.to_json())["space_key"] == front.space_key


def test_generate_best_compiles(tmp_path):
    d = autotune.generate_best(_spec(bits=16, tp=Fraction(1, 2)),
                               objective="energy", device="cpu",
                               cache_dir=str(tmp_path))
    assert d.mul(1234, 5678) == 1234 * 5678


def test_generate_best_runs_on_the_card_by_default(tmp_path):
    import torch
    spec = _spec(bits=16, tp=Fraction(1, 2))
    if torch.cuda.is_available():
        d = autotune.generate_best(spec, cache_dir=str(tmp_path))
        assert d.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autotune.generate_best(spec, cache_dir=str(tmp_path))


def test_registry_name_resolves(tmp_path):
    front = autotune.search("tbl8_w16_lowpower", cache_dir=str(tmp_path))
    assert len(front) >= 1


def test_objective_energy_spec_changes_pick():
    lp = designs.generate("tbl8_w32_lowpower", device="cpu")
    assert lp.spec.objective == "energy"
    assert lp.mul(0xCAFE, 0xBABE) == 0xCAFE * 0xBABE
    assert designs.generate("tbl8_w32_relaxed",
                            device="cpu").spec.objective == "area"


def test_spec_objective_round_trips():
    s = _spec(objective="energy")
    assert designs.DesignSpec.from_json(s.to_json()) == s
    with pytest.raises(Exception):
        _spec(objective="speed")
