"""One run of one cell: set-up, the measured window, the check, the line.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file (its ``file``), its traffic mix
(``traffic/<traffic>.json``, read by :mod:`.generator`), the driver of
the window that the mix's ``entry`` names (``drivers/<entry>.py``, which
builds the program) and one reader a metric (``metrics/<metric>.py``,
``read(record)``).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch

from portbench import report
from portbench.program_spans import ProgramRows
from portbench.spans import DeviceWindow, GcSpans, HostSpans

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
#: top-level module names that must not be loaded in a run: JAX and the
#: JAX package the port was made from (``repro_torch`` is the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ------------------------------------------------------------------ lookup

def load_benchmark(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def resolve(bench: dict, cell: str) -> tuple:
    """``(workload, config file, mix)`` of a cell, by name."""
    work = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if work is None:
        raise SystemExit(f"unknown workload {cell!r}; BENCHMARK.json has "
                         f"{[w['name'] for w in bench['workloads']]}")
    entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = json.loads((REPO / entry["file"]).read_text())
    mix = json.loads((ROOT / "traffic" / f"{work['traffic']}.json")
                     .read_text())
    return work, config, mix


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def load_reader(name: str):
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_driver(entry: str):
    """The ``Driver`` class of ``drivers/<entry>.py``."""
    return importlib.import_module(f"portbench.drivers.{entry}").Driver


# ------------------------------------------------------------------ record

@dataclasses.dataclass
class Record:
    """What the metric readers read."""
    setup_s: float
    calls: list                  # (start_s, end_s, items) a timed call
    spans: HostSpans | None      # traced runs
    device: DeviceWindow | None  # traced runs with device time recorded
    bound_s: float | None        # the frozen work bound of one call
    #: the program's rows, read stretch by stretch (traced runs); ``None``:
    #: read the whole window at once
    program: ProgramRows | None = None

    @property
    def n_calls(self) -> int:
        return len(self.calls)

    @property
    def items(self) -> int:
        return sum(n for _, _, n in self.calls)

    @property
    def window_s(self) -> float:
        """The window's time: the time inside its calls.  The
        benchmark's keeping of outputs between calls is off the clock."""
        return sum(self.call_s)

    @property
    def call_s(self) -> list:
        return [t1 - t0 for t0, t1, _ in self.calls]

    def span_s(self, name: str) -> float | None:
        return None if self.spans is None else self.spans.total_s(name)

    def per_call_ms(self, seconds: float | None) -> float | None:
        return None if seconds is None else seconds / self.n_calls * 1e3


# -------------------------------------------------------------------- run

#: the length of one profiler session in a traced window (s)
STRETCH_S = 2.5
#: the most calls in one stretch of a traced window with no profiler
#: session to size it (off the card): the program's rows are read well
#: before the ring holds too few
STRETCH_CALLS = 800


def stretches(seconds: float) -> int:
    """The time shares a traced window of ``seconds`` is cut into."""
    return max(1, round(seconds / STRETCH_S))


def measure(driver, seconds: float, first: int, parts: int = 1,
            stretch=None, max_calls=None) -> list:
    """Back-to-back calls until their time adds up to ``seconds``; the
    window ends with the call that crosses it.  A traced window runs as
    stretches, each inside ``stretch(calls)`` (a profiler session and the
    reading of the program's rows, started and ended between calls, off
    the clock); a stretch ends with the call that crosses the next of
    ``parts`` equal shares of the time, or with its ``max_calls``-th
    call (a number, or a function giving the next stretch's), whichever
    comes first, so that each call falls in exactly one stretch."""
    calls = []
    k, inside, share = first, 0.0, 1
    while inside < seconds:
        cap = max_calls() if callable(max_calls) else max_calls
        with stretch(calls) if stretch else nullcontext():
            n = 0
            while inside < seconds * share / parts and n != cap:
                t0 = time.perf_counter()
                out, items = driver.call(k)
                t1 = time.perf_counter()
                calls.append((t0, t1, items))
                inside += t1 - t0
                driver.keep(k, out)
                k += 1
                n += 1
        while share < parts and inside >= seconds * share / parts:
            share += 1               # the last call crossed this share
    return calls


def traced_stretch(rows: ProgramRows, dev: DeviceWindow | None):
    """A traced window's ``stretch``: a profiler session (on the card)
    inside the reading of the program's rows, which comes after the
    session has stopped."""
    @contextmanager
    def stretch(calls: list):
        with rows.stretch(calls), \
                dev.stretch(calls) if dev else nullcontext():
            yield
    return stretch


def describe_window(calls: list, gcs: GcSpans, load: tuple) -> str:
    times = sorted(t1 - t0 for t0, t1, _ in calls)
    half = len(calls) // 2 or 1
    halves = [statistics.median(t1 - t0 for t0, t1, _ in part)
              for part in (calls[:half], calls[half:] or calls)]
    between = calls[-1][1] - calls[0][0] - sum(t1 - t0 for t0, t1, _ in calls)
    return (f"window: {len(calls)} calls, {between:.6f} s between calls "
            f"(off the clock), halves' p50 {halves[0]:.6f} "
            f"{halves[1]:.6f}, call s min {times[0]:.6f} p50 "
            f"{statistics.median(times):.6f} p90 "
            f"{times[(len(times) - 1) * 9 // 10]:.6f} max "
            f"{times[-1]:.6f}; {gcs.describe()}; load average "
            f"{load[0]:.2f} -> {os.getloadavg()[0]:.2f}")


def power_limit(index: int = 0) -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return res.stdout.strip() or "unknown"


def run_cell(bench: dict, cell: str, seed: int, seconds: float,
             trace: bool, *, t_start: float, device="cuda",
             mix_override: dict | None = None, control: bool = False) -> dict:
    """One run of ``cell``; returns the fields of the result line.

    ``device="cpu"`` and ``mix_override`` let the tests drive a whole run
    at a small size on the CPU (the plain path, no device trace).
    ``control=True`` puts the driver's control in the program's place:
    its run must come out not correct."""
    phases = [("start", t_start), ("torch", time.perf_counter())]
    work, config, mix = resolve(bench, cell)
    mix = {**mix, **(mix_override or {})}
    device = torch.device(device)
    cuda = device.type == "cuda"
    driver = load_driver(mix["entry"])(
        config, mix, seed, device,
        lambda name: phases.append((name, time.perf_counter())))
    with driver.control() if control else nullcontext():
        for k in range(driver.warmup_calls):
            driver.call(k)
        if cuda:
            torch.cuda.synchronize(device)
        phases.append(("warm-up", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        print("set-up: " + ", ".join(
            f"{name} {t1 - t0:.3f} s" for (_, t0), (name, t1)
            in zip(phases, phases[1:])), file=sys.stderr)
        spans = HostSpans() if trace else None
        dev = DeviceWindow(driver.side) if trace and cuda else None
        rows = ProgramRows() if trace else None
        if spans:
            spans.install(driver.span_targets(), sync=cuda)
        load = os.getloadavg()
        try:
            with GcSpans() as gcs:
                calls = measure(driver, seconds, driver.warmup_calls,
                                stretches(seconds) if trace else 1,
                                traced_stretch(rows, dev) if trace else None,
                                dev.max_calls if dev else
                                STRETCH_CALLS if trace else None)
        finally:
            if spans:
                spans.remove()
    if cuda:
        torch.cuda.synchronize(device)
    print(describe_window(calls, gcs, load), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    driver.release()                   # free the program's state
    if cuda:
        torch.cuda.empty_cache()
    checks, attempted, failed = driver.check()
    rec = Record(setup_s=setup_s, calls=calls, spans=spans,
                 device=dev if dev and dev.measured else None,
                 bound_s=driver.bound_s, program=rows)
    kind = "per_layer" if trace else "end_to_end"
    metrics = [(m, load_reader(m["name"])(rec))
               for m in cell_metrics(bench, cell, kind)]
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": int(work["chips"]), "memory_peak_bytes": int(peak)}
    if cuda:
        info["power_limit"] = power_limit(device.index or 0)
    breakdown = None
    if rows is not None:
        print(rows.describe(), file=sys.stderr)
    if dev:
        print(dev.describe(), file=sys.stderr)
    if rec.device is not None:
        info["busy_s"] = rec.device.busy_s(program_only=True)
        info["window_s"] = rec.device.window_s
        breakdown = {"device_ops": rec.device.top_ops(),
                     "idle_gaps": rec.device.idle_gaps(
                         spans.intervals + gcs.named(), calls,
                         driver.label)}
    elif trace and cuda:
        print("device trace: the profiler recorded no device time; the "
              "device metrics are not measured", file=sys.stderr)
    return {"correct": failed == 0 and all(v <= lim for v, lim
                                           in checks.values()),
            "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": info, "breakdown": breakdown, "checks": checks,
            "record": rec}


def forbidden_modules() -> list:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_benchmark()
    work, _, _ = resolve(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(work["chips"]):
        print(f"{args.workload} needs {work['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 3
    res = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the run's process: {bad}: no result",
              file=sys.stderr)
        return 4
    rec = res["record"]
    print(f"{args.workload} seed {args.seed}: {rec.n_calls} timed calls "
          f"in {rec.window_s:.6f} s ({rec.items} items); set-up "
          f"{rec.setup_s:.6f} s")
    report.emit(res)
    return 0
