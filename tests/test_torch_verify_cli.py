"""``python -m repro_torch.verify`` against the reference's
``python -m repro.verify``: the same section and summary keys, and the
same registry, vocabulary, decompositions, fused and schedulers entries
(the reference's ``sweep_*`` functions, its jaxpr dataflow gate patched
out as ``tests/test_torch_verify.py`` does); a seeded violation exits
1; without CUDA the default device raises."""
import json

import pytest

import repro.verify as RV
import repro.verify.__main__ as RM
from repro_torch.verify import __main__ as TM
from repro_torch.verify import dataflow as TDF

SECTIONS = {"registry", "vocabulary", "decompositions", "fused",
            "dataflow", "schedulers", "bank", "lint"}


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = tmp_path_factory.mktemp("verify") / "VERIFY_torch_report.json"
    assert TM.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    return json.loads(out.read_text())


@pytest.fixture
def reference(monkeypatch):
    monkeypatch.setattr(RV, "assert_plan_dataflow", lambda *a, **k: None)
    return RM


def test_smoke_report_has_the_reference_keys(report):
    assert SECTIONS <= set(report) and "kernels" not in report
    assert set(report["summary"]) == {"sections", "violations", "ok"}
    assert set(report["summary"]["sections"]) == SECTIONS
    assert report["summary"]["ok"] and report["violations"] == []
    assert report["smoke"] and report["widths"] == list(TM.SMOKE_WIDTHS)
    assert report["device"] == "cpu"
    assert TM.SMOKE_WIDTHS == RM.SMOKE_WIDTHS
    assert TM.SMOKE_TPS == RM.SMOKE_TPS
    assert (TM.FULL_WIDTHS, TM.FULL_TPS) == (RM.FULL_WIDTHS, RM.FULL_TPS)


def test_registry_and_fused_equal_the_references(report, reference):
    for name in ("registry", "fused"):
        want, vs = getattr(reference, f"sweep_{name}")()
        assert not vs
        assert report[name] == json.loads(json.dumps(want)), name


def test_vocabulary_and_decompositions_equal_the_references(report,
                                                            reference):
    want, vs = reference.sweep_vocabulary(RM.SMOKE_WIDTHS)
    assert not vs and report["vocabulary"] == json.loads(json.dumps(want))
    want, vs = reference.sweep_decompositions(RM.SMOKE_TPS)
    assert not vs and report["decompositions"] == want


def test_schedulers_equal_the_references(report):
    import repro.serving  # noqa: F401 -- registers slo_edf
    from repro.core.bank.schedule import SCHEDULERS
    assert report["schedulers"] == [{
        "cases": len(RV.contracts.SCHEDULER_CASES),
        "policies": sorted(SCHEDULERS), "ok": True}]


def test_dataflow_bank_and_lint_sections(report):
    launches = [e for e in report["dataflow"] if "launches" in e]
    assert len(launches) == 13 + 3 * len(TM._vocabulary())
    standalone = [e for e in report["dataflow"]
                  if "launch" in e and "batch" not in e]
    assert [e["launch"].split("[")[0] for e in standalone] == [
        "karatsuba_ppm", "prefix_adder", "int8_matmul"]
    ragged = [e["batch"] for e in report["dataflow"] if "batch" in e]
    assert tuple(ragged) == TDF.RAGGED_BATCHES
    assert all(e["ok"] for e in report["dataflow"])
    assert report["bank"] == [{"checked_plans": 2, "backends":
                               ["core", "kernel", "fused"],
                               "device": "cpu", "ok": True}]
    assert report["lint"][0]["ok"]


def test_dataflow_contracts_cover_the_sections_launches():
    contracts = TM.dataflow_contracts(TM.SMOKE_WIDTHS)
    assert {c.kernel for c in contracts.values()} >= {
        "bank_fold_launch", "bank_fold_bulk_launch", "mcim_fold_launch",
        "mcim_fold_bulk_launch", "mcim_fold_karatsuba_launch",
        "karatsuba_ppm_launch", "prefix_adder_launch", "int8_matmul_launch"}
    assert all(TDF.analyze_contract(c).ok for c in contracts.values())


def test_seeded_violation_exits_one(tmp_path, monkeypatch, capsys):
    """A shared-memory budget below the bulk kernels' blocks."""
    monkeypatch.setattr(TDF, "DEFAULT_SMEM_BUDGET", 4096)
    TDF.clear_caches()
    try:
        out = tmp_path / "r.json"
        assert TM.main(["--smoke", "--device", "cpu", "--out",
                        str(out)]) == 1
    finally:
        TDF.clear_caches()
    rep = json.loads(out.read_text())
    assert not rep["summary"]["ok"]
    assert {v["rule"] for v in rep["violations"]} == {"smem-budget"}
    assert "FAIL" in capsys.readouterr().out


def test_default_device_is_the_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs the kernels "
                    "section (chip_smoke.py phase 13)")
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.main(["--smoke", "--out", str(tmp_path / "r.json")])
