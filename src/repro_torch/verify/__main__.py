"""``python -m repro_torch.verify``: sweep every generatable design and report.

Counterpart of the reference's ``verify/__main__.py``.  Sections of the
sweep (each contributes to ``VERIFY_torch_report.json``):

  registry        every named design in ``repro_torch.designs.registry``,
                  planned exactly as ``generate()`` plans it;
  vocabulary      every instance architecture the autotuner can emit
                  (star; fb/ff over the CT set; Karatsuba levels x
                  adders; signed variants) at widths 8..128, on every
                  substrate;
  decompositions  sample fractional TPs decomposed by
                  ``autotune.candidates.enumerate_configs``, every
                  candidate checked for throughput + instance safety;
  fused           bank-level fused-kernel contracts of every registry
                  plan (super-geometry idle masks, table consistency,
                  window coverage, scratch domination);
  dataflow        static proofs of every CUDA launch the registry +
                  vocabulary imply (both substrates), the standalone
                  kernels and ragged batches through the tiler: hazard
                  freedom, block and window bounds, the shared-memory
                  model and budget, and the static bytes/operations
                  roofline per launch;
  schedulers      determinism/completeness/makespan contracts of every
                  registered dispatch policy;
  bank            ``Bank.dispatch_fn`` staticness on fake tensors, every
                  backend, on ``--device``;
  lint            the AST rules of :mod:`.lint` over ``src/repro_torch``;
  kernels         (``--device cuda`` only) every contract of the
                  dataflow section held to the built kernels: the
                  launcher's ``*_launch_shape`` equals the declared
                  grid, threads and shared memory, no spills, the
                  threads within the kernel's limit, static plus
                  dynamic shared memory within the card's opt-in.

Nothing multiplies on either device: the bank section runs on fake
tensors.  Exit status 1 when any violation is found.  ``--smoke``
shrinks the width/TP grids; ``--device`` defaults to ``cuda`` and
raises without a CUDA card, as every entry point does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
from fractions import Fraction

from repro_torch.core.mcim import MCIMConfig
from repro_torch.device import resolve_device

from . import contracts, intervals, lint, verify_instance

FULL_WIDTHS = (8, 16, 24, 32, 48, 64, 96, 128)
SMOKE_WIDTHS = (8, 32, 128)
FULL_TPS = ("1/2", "1/3", "5/6", "11/12", "7/2")
SMOKE_TPS = ("1/2", "5/6")
#: plans and backends of the bank section
BANK_TPS = (Fraction(7, 2), Fraction(5, 6))
BANK_BACKENDS = ("core", "kernel", "fused")


def _vocabulary():
    """Every instance design the planner/autotuner can emit."""
    from repro_torch.autotune.candidates import CT_SET, KARATSUBA_LEVELS
    vocab = [MCIMConfig(arch="star", ct=1)]
    for ct in CT_SET:
        vocab.append(MCIMConfig(arch="fb", ct=ct))
        vocab.append(MCIMConfig(arch="ff", ct=ct))
    for levels in KARATSUBA_LEVELS:
        for adder in ("1ca", "3ca"):
            vocab.append(MCIMConfig(arch="karatsuba", ct=3,
                                    levels=levels, adder=adder))
    vocab.extend(dataclasses.replace(cfg, signed=True) for cfg in list(vocab))
    return tuple(vocab)


def _cfg_label(cfg: MCIMConfig) -> str:
    parts = [cfg.arch, f"ct={cfg.ct}"]
    if cfg.arch == "karatsuba":
        parts.append(f"K={cfg.levels}")
    if cfg.adder != "1ca":
        parts.append(cfg.adder)
    if cfg.signed:
        parts.append("signed")
    return "(".join([parts[0], ",".join(parts[1:])]) + ")"


def _viol_json(v) -> dict:
    return dataclasses.asdict(v)


def _registry_plans():
    """(name, spec, plan or the VerificationError) of every registry
    design, planned as generate() plans it."""
    from repro_torch.designs import registry
    from repro_torch.designs.compile import _plan_with_timing
    from . import VerificationError
    for name in sorted(registry.names()):
        spec = registry.get(name)
        try:
            plan, _ = _plan_with_timing(spec)
        except VerificationError as e:
            yield name, spec, e
            continue
        yield name, spec, plan


def sweep_registry() -> tuple:
    """Plan every registered design the way generate() would, verify."""
    results, violations = [], []
    for name, spec, plan in _registry_plans():
        if isinstance(plan, Exception):
            violations.extend(plan.violations)
            results.append({"design": name, "ok": False,
                            "violations": len(plan.violations)})
            continue
        entry = {"design": name, "ok": True,
                 "throughput": str(plan.throughput), "instances": []}
        for count, cfg in plan.configs:
            rep = intervals.analyze(spec.bits_a, spec.bits_b, cfg)
            entry["instances"].append({
                "config": _cfg_label(cfg), "count": count,
                "headroom_bits": rep.headroom_bits,
                "required_width": rep.required_width})
        results.append(entry)
    return results, violations


def sweep_vocabulary(widths) -> tuple:
    results, violations = [], []
    for w in widths:
        for cfg in _vocabulary():
            vs = verify_instance(w, w, cfg)
            violations.extend(vs)
            rep = intervals.analyze(w, w, cfg)
            results.append({
                "bits": w, "config": _cfg_label(cfg),
                "ok": not vs, "headroom_bits": rep.headroom_bits,
                "required_width": rep.required_width})
    return results, violations


def sweep_decompositions(tps, bits: int = 32) -> tuple:
    from repro_torch.designs import DesignSpec
    from repro_torch.autotune.candidates import enumerate_configs
    results, violations = [], []
    for tp in tps:
        spec = DesignSpec(bits, bits, Fraction(tp))
        n_checked = 0
        bad = 0
        for configs in enumerate_configs(spec):
            vs = list(contracts.check_throughput(configs, spec.throughput))
            for _, cfg in configs:
                vs.extend(verify_instance(bits, bits, cfg))
            n_checked += 1
            if vs:
                bad += 1
                violations.extend(vs)
        results.append({"tp": tp, "bits": bits,
                        "candidates": n_checked, "failing": bad})
    return results, violations


def sweep_fused() -> tuple:
    """Fused-kernel contracts of every registry plan: the proof
    obligations of running that plan as ONE launch."""
    results, violations = [], []
    for name, spec, plan in _registry_plans():
        if isinstance(plan, Exception):
            continue              # already reported by sweep_registry
        vs = list(contracts.check_fused_plan(spec.bits_a, spec.bits_b,
                                             plan.configs))
        worst = None
        for _, cfg in plan.configs:
            vs.extend(contracts.check_fused_schedule(
                spec.bits_a, spec.bits_b, cfg))
            vs.extend(contracts.check_fused_widths(
                spec.bits_a, spec.bits_b, cfg))
            rep = intervals.analyze(spec.bits_a, spec.bits_b, cfg,
                                    substrate="fused")
            vs.extend(rep.violations)
            if worst is None or rep.headroom_bits < worst:
                worst = rep.headroom_bits
        violations.extend(vs)
        results.append({"design": name, "ok": not vs,
                        "fused_headroom_bits": worst})
    return results, violations


def _launch_entry(r) -> dict:
    return {"launch": r.name, "path": r.path, "grid": list(r.grid),
            "block": r.block, "flops": r.flops, "hbm_bytes": r.hbm_bytes,
            "arith_intensity": round(r.arith_intensity, 4),
            "bound_ms": r.bound_ms, "bound_by": r.bound_by,
            "smem_bytes": r.smem["dynamic_bytes"], "ok": r.ok}


def dataflow_contracts(widths) -> dict:
    """Every distinct launch contract the dataflow section analyzes, by
    name: the registry's and the vocabulary's launches on both
    substrates, the standalone kernels and the ragged batches."""
    from repro_torch.core import limbs as L
    from . import dataflow
    out = {}
    plans = [(spec.bits_a, spec.bits_b, plan.configs)
             for _, spec, plan in _registry_plans()
             if not isinstance(plan, Exception)]
    plans += [(w, w, ((1, cfg),)) for w in widths for cfg in _vocabulary()]
    for bits_a, bits_b, configs in plans:
        for substrate in ("kernel", "fused"):
            for c in dataflow.plan_contracts(bits_a, bits_b, configs,
                                             substrate):
                out[c.name] = c
    for c in dataflow.standalone_contracts():
        out[c.name] = c
    la = L.n_limbs_for_bits(32)
    for batch in dataflow.RAGGED_BATCHES:
        c = dataflow._kernel_contract(la, la, "fb", 2, batch)
        out[c.name] = c
    return out


def sweep_dataflow(widths) -> tuple:
    """Static dataflow proofs of every CUDA launch the repo can plan.

    Registry plans and the full autotuner vocabulary (both substrates:
    per-instance ``mcim_fold`` launches and the fused bank launch), the
    standalone kernels, and ragged/prime batch shapes through the
    tiler.  Distinct launch geometries are analyzed once (cached), so
    the sweep cost scales with geometry variety, not design count.
    """
    from . import dataflow
    results, violations = [], []

    def plan_entry(bits_a, bits_b, configs):
        reps = []
        for substrate in ("kernel", "fused"):
            reps.extend(dataflow.analyze_plan(bits_a, bits_b, configs,
                                              substrate=substrate))
        return reps, [v for rep in reps for v in rep.violations]

    for name, spec, plan in _registry_plans():
        if isinstance(plan, Exception):
            continue              # already reported by sweep_registry
        reps, vs = plan_entry(spec.bits_a, spec.bits_b, plan.configs)
        violations.extend(vs)
        results.append({"design": name, "ok": not vs,
                        "launches": [_launch_entry(r) for r in reps]})

    for w in widths:
        for cfg in _vocabulary():
            reps, vs = plan_entry(w, w, ((1, cfg),))
            violations.extend(vs)
            results.append({"bits": w, "config": _cfg_label(cfg),
                            "ok": not vs,
                            "launches": [r.name for r in reps]})

    for rep in dataflow.analyze_standalone():
        violations.extend(rep.violations)
        results.append(_launch_entry(rep))

    for batch, rep in zip(dataflow.RAGGED_BATCHES,
                          dataflow.analyze_tiling()):
        violations.extend(rep.violations)
        results.append({"launch": rep.name, "batch": batch,
                        "path": rep.path, "grid": list(rep.grid),
                        "ok": rep.ok})
    return results, violations


def sweep_bank(device, bits: int = 32) -> tuple:
    """``check_bank_static`` of two plans on every backend, on fake
    tensors of ``device``."""
    from repro_torch.core import planner
    violations = []
    for tp in BANK_TPS:
        plan = planner.plan_throughput(bits, bits, tp)
        for backend in BANK_BACKENDS:
            violations.extend(contracts.check_bank_static(
                plan, bits, bits, backend=backend, device=device))
    return ([{"checked_plans": len(BANK_TPS), "backends":
              list(BANK_BACKENDS), "device": str(device),
              "ok": not violations}], violations)


def sweep_kernels(widths) -> tuple:
    """Every contract of the dataflow section against the built kernels
    on the current card (:func:`.dataflow.check_on_card`)."""
    from . import dataflow
    results, violations = [], []
    for contract in dataflow_contracts(widths).values():
        record, vs = dataflow.check_on_card(contract)
        results.append(record)
        violations.extend(vs)
    return results, violations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify",
        description="statically verify every generatable design")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced width/TP grids (the pre-merge gate)")
    ap.add_argument("--out", default="VERIFY_torch_report.json",
                    help="report path (default: %(default)s)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the bank section's fake tensors; "
                         "cuda also holds every launch contract to the "
                         "built kernels (default: %(default)s)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    widths = SMOKE_WIDTHS if args.smoke else FULL_WIDTHS
    tps = SMOKE_TPS if args.smoke else FULL_TPS

    sections, all_violations = {}, []

    print(f"repro_torch.verify sweep ({'smoke' if args.smoke else 'full'},"
          f" {device}): widths {widths}, TPs {tps}")

    sections["registry"], vs = sweep_registry()
    all_violations.extend(vs)
    print(f"  registry:       {len(sections['registry'])} designs, "
          f"{len(vs)} violations")

    sections["vocabulary"], vs = sweep_vocabulary(widths)
    all_violations.extend(vs)
    print(f"  vocabulary:     {len(sections['vocabulary'])} design "
          f"points, {len(vs)} violations")

    sections["decompositions"], vs = sweep_decompositions(tps)
    all_violations.extend(vs)
    n_cand = sum(r["candidates"] for r in sections["decompositions"])
    print(f"  decompositions: {n_cand} candidates, {len(vs)} violations")

    sections["fused"], vs = sweep_fused()
    all_violations.extend(vs)
    print(f"  fused:          {len(sections['fused'])} plans as one "
          f"launch, {len(vs)} violations")

    sections["dataflow"], vs = sweep_dataflow(widths)
    all_violations.extend(vs)
    print(f"  dataflow:       {len(sections['dataflow'])} launch "
          f"points, {len(vs)} violations")

    # the serving package registers its slo_edf policy at import: pull
    # it in before the sweep so an unverifiable serving scheduler fails
    # here (and is therefore unplannable)
    import repro_torch.serving  # noqa: F401
    from repro_torch.core.bank.schedule import SCHEDULERS
    vs = contracts.check_all_schedulers()
    sections["schedulers"] = [{"cases": len(contracts.SCHEDULER_CASES),
                               "policies": sorted(SCHEDULERS),
                               "ok": not vs}]
    all_violations.extend(vs)
    print(f"  schedulers:     {len(contracts.SCHEDULER_CASES)} cases x "
          f"{len(SCHEDULERS)} policies, {len(vs)} violations")

    sections["bank"], vs = sweep_bank(device)
    all_violations.extend(vs)
    print(f"  bank statics:   {len(vs)} violations")

    import repro_torch
    src_root = pathlib.Path(repro_torch.__file__).parent
    vs = lint.lint_tree(src_root)
    sections["lint"] = [{"root": str(src_root), "ok": not vs}]
    all_violations.extend(vs)
    print(f"  lint:           {src_root}, {len(vs)} violations")

    if device.type == "cuda":
        sections["kernels"], vs = sweep_kernels(widths)
        all_violations.extend(vs)
        print(f"  kernels:        {len(sections['kernels'])} launch "
              f"contracts on the card, {len(vs)} violations")

    report = {
        "smoke": args.smoke,
        "device": str(device),
        "widths": list(widths),
        "summary": {
            "sections": {k: len(v) for k, v in sections.items()},
            "violations": len(all_violations),
            "ok": not all_violations,
        },
        "violations": [_viol_json(v) for v in all_violations],
        **sections,
    }
    out_path = pathlib.Path(args.out)
    out_path.write_text(json.dumps(report, indent=2, sort_keys=True))
    print(f"report: {out_path}")

    if all_violations:
        print(f"FAIL: {len(all_violations)} violation(s)")
        for v in all_violations[:20]:
            print(f"  {v.describe()}")
        if len(all_violations) > 20:
            print(f"  ... and {len(all_violations) - 20} more")
        return 1
    print("OK: every design proved overflow-safe and contract-conformant")
    return 0


if __name__ == "__main__":
    sys.exit(main())
