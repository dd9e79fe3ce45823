"""The port's user entry points, ``examples_torch/*.py``, against the
reference's ``examples/*.py`` on the CPU (``--device cpu``).

``quickstart``, ``fractional_throughput`` and ``exact_determinism``
print the reference's lines: both scripts run in this process (the
reference's with its jaxpr dataflow gate patched out, as
``tests/test_torch_designs.py`` does), with both autotune caches under
``tmp_path``, and every line must be equal, except that

* the port's ``CompiledDesign.describe`` also names its device
  (``  device=cpu``), which is dropped before comparing;
* the reference's ``vmem:`` line is the port's ``working set (silicon
  model):`` line, with equal numbers (the paper's working-set model,
  not a memory size of either chip);
* in ``exact_determinism`` the two float32 ``sum`` lines may differ
  (two libraries reduce in different orders); the MCIM lines may not.

``sharded_bank`` runs the reference in a subprocess on two forced host
devices and the port on ``--devices cpu,cpu``; the lines they share are
equal.  ``serve_quant`` and ``train_e2e`` hold the reference's own
asserts.  Without CUDA, every example raises unless told the CPU.
"""
import contextlib
import io
import os
import pathlib
import re
import runpy
import subprocess
import sys

import pytest
import torch

import repro.verify

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAMES = ("quickstart", "fractional_throughput", "sharded_bank",
         "exact_determinism", "serve_quant", "train_e2e")
#: the port's ``describe`` field the reference's has not
DEVICE_FIELD = re.compile(r"  device=[^\]\s]+")


def _main(package, name):
    return runpy.run_path(str(ROOT / package / f"{name}.py"))["main"]


def _lines(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue().splitlines()


@pytest.fixture
def caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "port"))
    monkeypatch.setattr(repro.verify, "assert_plan_dataflow",
                        lambda *a, **k: None)


def _both(name):
    want = _lines(_main("examples", name))
    got = _lines(_main("examples_torch", name), ["--device", "cpu"])
    return want, [DEVICE_FIELD.sub("", line) for line in got]


def _numbers(line):
    return re.findall(r"-?\d+(?:\.\d+)?%?", line)


@pytest.mark.parametrize("name", ["quickstart", "fractional_throughput"])
def test_design_examples_print_the_reference_lines(caches, name):
    want, got = _both(name)
    assert len(got) == len(want) > 10
    for w, g in zip(want, got):
        if w.startswith("vmem: "):
            assert g.startswith("working set (silicon model): ")
            assert _numbers(g) == _numbers(w), (g, w)
        else:
            assert g == w
    assert any(line.endswith(": True") for line in got)
    assert not any("FAIL" in line or "False" in line for line in got)


def test_exact_determinism_prints_the_reference_lines(caches):
    want, got = _both("exact_determinism")
    assert len(got) == len(want)
    for w, g in zip(want[:2], got[:2]):        # float32 sums: same form
        assert g.split(":")[0] == w.split(":")[0]
    assert got[2:] == want[2:]
    assert got[3].endswith("equal: True")


def test_sharded_bank_prints_the_reference_lines():
    code = ("import repro.verify, runpy\n"
            "repro.verify.assert_plan_dataflow = lambda *a, **k: None\n"
            f"runpy.run_path({str(ROOT / 'examples' / 'sharded_bank.py')!r}"
            ", run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    want = run.stdout.splitlines()
    got = [DEVICE_FIELD.sub("", line) for line in _lines(
        _main("examples_torch", "sharded_bank"), ["--devices", "cpu,cpu"])]
    assert len(got) == len(want)
    # the reference's output sharding spec is the port's replica devices
    where = [i for i, line in enumerate(want)
             if line.startswith("output sharding spec:")]
    assert len(where) == 1
    i = where[0]
    assert got[i] == "replica devices: cpu, cpu (products gathered on cpu)"
    assert got[:i] + got[i + 1:] == want[:i] + want[i + 1:]
    assert "bit-exact over 56 ops: True" in got


def test_serve_quant_serves_every_request():
    eng = _main("examples_torch", "serve_quant")(["--device", "cpu"])
    assert len(eng.outputs) == 6
    assert all(len(toks) >= 8 for toks in eng.outputs.values())
    assert len(eng.arrival_trace()) == 6


def test_train_e2e_reduces_the_loss(tmp_path):
    res = _main("examples_torch", "train_e2e")(
        ["--steps", "6", "--checkpoint-dir", str(tmp_path), "--device",
         "cpu"])
    assert res.final_step == 6 and res.losses[-1] < res.losses[0]


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA")
@pytest.mark.parametrize("name", NAMES)
def test_examples_raise_without_cuda(name):
    with pytest.raises(RuntimeError, match="cuda|CUDA|card"):
        _main("examples_torch", name)([])
