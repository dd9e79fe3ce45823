"""BENCHMARK.json against the files it names, and what the harness may
import."""
import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    """Top-level names of every module a file imports (at any depth)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for kind in ("configs", "workloads", "end_to_end",
                                    "per_layer") for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    work = next(w for w in BENCH["workloads"] if w["name"] == cell)
    config = next(c for c in BENCH["configs"] if c["name"] == work["config"])
    assert (REPO / config["file"]).is_file()
    assert json.loads((REPO / config["file"]).read_text())["name"] == \
        config["name"]
    assert (ROOT / "traffic" / f"{work['traffic']}.json").is_file()
    reported = [m for kind in ("end_to_end", "per_layer")
                for m in BENCH[kind]
                if "workloads" not in m or cell in m["workloads"]]
    for m in reported:
        assert (ROOT / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    e2e = {m["name"] for m in reported if "bound" in m}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any("layer" in m for m in reported)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_is_the_registry_design_uncut(name):
    from repro_torch.designs import USE_CASES, DesignSpec
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    config = json.loads((REPO / entry["file"]).read_text())
    assert DesignSpec.from_dict(config["spec"]) == USE_CASES[name]
    assert entry["reduced"] == config["reduced"] == []
    assert entry["source"] == config["source"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_workloads_report_what_they_move(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
    assert m["workloads"]
    for cell in m["workloads"]:
        assert "workloads" not in moved or cell in moved["workloads"]


def test_every_metric_file_is_named_in_the_benchmark():
    named = {m["name"] for kind in ("end_to_end", "per_layer")
             for m in BENCH[kind]}
    assert {p.stem for p in (ROOT / "metrics").glob("*.py")} == named


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in ROOT.rglob("*.py")))
def test_no_jax_or_jax_package_import(path):
    names = _imports(ROOT / path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if path in ("reference.py", "roofline.py"):
        assert "repro_torch" not in names
