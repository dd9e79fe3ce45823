"""Whole runs of the harness on the CPU at a small size: sound runs come
out correct, the control and every planted fault come out not correct.

The look for a card is skipped (``run_cell(device="cpu")``); the design
runs its plain PyTorch path."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import harness, report

REPO = Path(__file__).resolve().parent.parent
BENCH = harness.load_benchmark()
SMALL = {"bulk": {"batch": 2048, "pool_bytes": 40_000, "sample_rows": 64},
         "serve": {"requests": 40, "traces": 2}}
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 77


def _run(cell, trace=False, control=False, seconds=0.3):
    mix = SMALL[cell.split(".")[1]]
    return harness.run_cell(BENCH, cell, SEED, seconds, trace,
                            t_start=time.perf_counter(), device="cpu",
                            mix_override=mix, control=control)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, trace):
    res = _run(cell, trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    line = report.assemble(res)
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in harness.cell_metrics(BENCH, cell, kind)
             if m["source"] != "device_trace"}
    assert set(line["metrics"]) == names
    assert list(line)[-1] == "checks"
    assert all(v["value"] == 0 and v["limit"] == 0
               for v in line["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = _run(cell, control=True)
    assert not res["correct"] and res["failed"] > 0
    checks = res["checks"]
    if "calls_fingerprint_differs" in checks:
        calls = res["record"].n_calls
        assert checks["calls_fingerprint_differs"][0] == calls
        assert checks["sampled_products_wrong"][0] > calls * 64 // 4
    else:
        assert res["failed"] > res["attempted"] // 4


def _unwritten(execute, bank, a, b):
    out = execute(bank, a, b)
    return torch.zeros_like(out)


def _half_left_out(execute, bank, a, b):
    out = execute(bank, a, b).clone()
    out[out.shape[0] // 2:] = 0
    return out


def _one_altered(execute, bank, a, b):
    out = execute(bank, a, b).clone()
    out[out.shape[0] // 3, 0] = (out[out.shape[0] // 3, 0] + 1) & 0xFFFF
    return out


FAULTS = {"unwritten": _unwritten, "half_left_out": _half_left_out,
          "one_altered": _one_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.core.bank import Bank
    execute = Bank.execute
    monkeypatch.setattr(Bank, "execute", lambda bank, a, b:
                        FAULTS[fault](execute, bank, a, b))
    res = _run(cell)
    assert not res["correct"] and res["failed"] > 0


@pytest.mark.parametrize("fault", ["dropped", "refused"])
def test_serve_missing_answers_are_not_correct(fault, monkeypatch):
    from repro_torch.designs import CompiledDesign
    serve = CompiledDesign.serve

    def faulty(self, requests, **kw):
        rep, responses = serve(self, requests, **kw)
        rid = sorted(responses)[len(responses) // 2]
        if fault == "dropped":
            del responses[rid]
        else:
            responses[rid] = dataclasses.replace(responses[rid],
                                                 admitted=False)
        return rep, responses

    monkeypatch.setattr(CompiledDesign, "serve", faulty)
    res = _run("tp3p5_w32.serve")
    assert not res["correct"]
    assert res["checks"]["requests_unanswered"][0] > 0


def test_report_refuses_a_device_metric_from_the_cpu():
    res = _run("tp3p5_w32.bulk", trace=True)
    entry = next(m for m in BENCH["per_layer"]
                 if m["name"] == "dispatch_ms.bulk")
    res["metrics"].append((entry, 1.0))
    with pytest.raises(ValueError, match="device metric"):
        report.assemble(res)


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/ (no src/)
    the command exits non-zero and prints no result, on any machine."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_main_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: main would run the cell")
    rc = harness.main(["--workload", CELLS[0], "--seed", "1",
                       "--seconds", "1"], time.perf_counter())
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro.fake" in harness.forbidden_modules()
